"""Requests answered by the window's serve calls, over the window's time
(the time inside its calls)."""


def read(rec):
    return rec.items / rec.window_s
