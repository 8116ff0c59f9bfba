"""Grid points x AR steps of every forecast completed in the window, over
the window's length (host clock)."""


def read(run):
    w = run.window
    return w.points / w.seconds if w.points and w.seconds > 0 else None
