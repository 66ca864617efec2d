"""The engine's host time a call, in ms: the mean over the window's calls
of a call's wall less the device's busy time inside it (the union of the
profiler's kernels and copies)."""


def read(win):
    if not win.device:
        return None
    return (win.latencies_s.sum() - win.busy_s()) / win.calls * 1e3
