"""The static scan's share of its roofline, in %: the recurrent layer's
bound for each call's events (the larger of its operations over the f32
peak and its bytes over the memory bandwidth) over the device time of the
in-loop static scan kernels (``cluster_scan_kernel`` without the zx
mode).  Nothing to read where no such kernel ran."""

import re

from perfbench.arith import rnn_bound_s

STATIC_SCAN = re.compile(r"cluster_scan_kernel<\d+, false")


def read(win):
    ns = sum(e - s for name, s, e in win.kernels() if STATIC_SCAN.search(name))
    if not ns:
        return None
    return win.calls * rnn_bound_s(win.cfg, win.rows) / (ns * 1e-9) * 100
