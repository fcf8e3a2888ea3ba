"""Mean time in the system, s, of the requests due in the window (an unfinished
one at its age at the window's end)."""

from servebench.latency import ttlt_mean


def read(w):
    if w.kind != "poisson":
        return None
    return ttlt_mean(w.recs.values(), w.start, w.end)
