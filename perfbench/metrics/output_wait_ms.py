"""The host's wait for a request's answer, in ms: the mean over the
window's requests of its ``engine.d2h`` span (``.cpu().numpy()``: the
device's queue drains, then the copy back).  Nothing to read where the
window holds no program spans."""

from perfbench.spans import per_call


def read(win):
    ns = per_call(win, ("engine.d2h",))
    return None if ns is None else float(ns.mean()) * 1e-6
