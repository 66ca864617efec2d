"""The share of the traced window, in %, in which no kernel or copy ran
on the device (the union of the profiler's device intervals)."""


def read(win):
    if not win.device:
        return None
    return (1.0 - win.busy_s() / win.window_s) * 100
