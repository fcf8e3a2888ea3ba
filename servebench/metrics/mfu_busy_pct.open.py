"""Per-layer metric ``mfu_busy_pct.open``: see ``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.mfu_busy_pct(w)
