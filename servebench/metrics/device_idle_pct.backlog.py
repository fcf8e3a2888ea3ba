"""Per-layer metric ``device_idle_pct.backlog``: see ``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.device_idle_pct(w)
