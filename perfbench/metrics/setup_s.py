"""From the process's start, before ``import torch``, to the window's
first call (host clock)."""


def read(win):
    return win.setup_s
