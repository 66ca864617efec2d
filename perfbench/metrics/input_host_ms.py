"""The host's time getting a request's input onto the device, in ms: the
mean over the window's requests of its ``engine.stage``
(``np.ascontiguousarray``, ``torch.from_numpy``) and ``engine.h2d`` (the
pageable copy) spans.  Nothing to read where the window holds no program
spans."""

from perfbench.spans import per_call


def read(win):
    ns = per_call(win, ("engine.stage", "engine.h2d"))
    return None if ns is None else float(ns.mean()) * 1e-6
