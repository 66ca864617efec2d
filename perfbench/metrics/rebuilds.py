"""Builds inside the window: signatures the compile cache readied cold
plus ``nvcc`` runs, read at each root span's edges and summed over the
window's requests.  Nothing to read where the window holds no program
spans."""

from perfbench.spans import counters


def read(win):
    n = counters(win, "builds")
    return None if n is None else float(n.sum())
