"""The engine's host time a call, in us: as ``engine_host_ms``."""


def read(win):
    if not win.device:
        return None
    return (win.latencies_s.sum() - win.busy_s()) / win.calls * 1e6
