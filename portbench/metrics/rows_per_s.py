"""Input rows of every query completed in the window, summed, over the
window's seconds on the host clock (the window runs from the first query's
call to the last one's synchronize)."""


def read(w):
    return w.rows / w.window_s if w.window_s > 0 and w.completed else None
