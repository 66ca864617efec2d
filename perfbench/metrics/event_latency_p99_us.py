"""The 99th percentile of every single-event call of the window, from the
call to its answer on the host (host clock), in us."""

from perfbench.trace import percentile


def read(win):
    return percentile(win.latencies_s, 99) * 1e6
