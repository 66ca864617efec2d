"""The host's time issuing a request's kernels, in ms: the mean over the
window's requests of its ``model.forward`` span (the scan wrapper's
residency lookup, pad, layout and launch, the head's products and stock
ops).  Nothing to read where the window holds no program spans."""

from perfbench.spans import per_call


def read(win):
    ns = per_call(win, ("model.forward",))
    return None if ns is None else float(ns.mean()) * 1e-6
