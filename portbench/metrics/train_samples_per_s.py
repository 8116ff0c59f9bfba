"""Samples trained through a whole AR BPTT step in the window, over the
window's length (host clock)."""


def read(run):
    w = run.window
    return w.samples / w.seconds if w.samples and w.seconds > 0 else None
