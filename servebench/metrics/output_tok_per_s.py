"""Output tokens emitted in the window over its seconds."""

from servebench.latency import window_tokens


def read(w):
    if w.seconds <= 0:
        return None
    return window_tokens(w.recs.values(), w.start, w.end) / w.seconds
