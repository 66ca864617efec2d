"""Device kernels in the traced window over the calls in it."""


def read(win):
    if not win.device:
        return None
    return len(win.kernels()) / win.calls
