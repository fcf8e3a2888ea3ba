"""95th percentile of the time to first token, s, of the requests due in the
window (one with no token at its age at the window's end)."""

from servebench.latency import ttft_quantile


def read(w):
    if w.kind != "poisson":
        return None
    return ttft_quantile(w.recs.values(), w.start, w.end, 0.95)
