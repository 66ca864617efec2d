"""Events answered in the window over the window's seconds (host clock)."""


def read(win):
    return win.events / win.window_s
