"""The engine's own host time a request, in us: the mean over the
window's requests of the root span's (``engine.predict``) self time, its
duration less its child spans' (target and key resolution, the executor's
signature lookup, ``inference_mode``).  Nothing to read where the window
holds no program spans."""

from perfbench.spans import root_self


def read(win):
    own = root_self(win)
    return None if own is None else float(own.mean()) * 1e-3
