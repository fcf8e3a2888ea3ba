"""99th percentile, ms, of every gap between consecutive output tokens of one
request in the window (a started, unfinished request's open gap to the
window's end included)."""

from servebench.latency import gap_quantile


def read(w):
    q = gap_quantile(w.recs.values(), w.start, w.end, 0.99)
    return None if q is None else q * 1e3
