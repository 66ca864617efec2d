"""The port's own kernel launches a request (``cuda.LAUNCHES``, read at
the root span's edges), the mean over the window's requests.  Nothing to
read where the window holds no program spans."""

from perfbench.spans import counters


def read(win):
    n = counters(win, "launches")
    return None if n is None else float(n.mean())
