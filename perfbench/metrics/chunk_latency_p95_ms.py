"""The 95th percentile of every call of the window, from the call to its
answer on the host (host clock), in ms."""

from perfbench.trace import percentile


def read(win):
    return percentile(win.latencies_s, 95) * 1e3
