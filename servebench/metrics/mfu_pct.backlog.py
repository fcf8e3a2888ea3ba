"""Per-layer metric ``mfu_pct.backlog``: see ``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.mfu_pct(w)
