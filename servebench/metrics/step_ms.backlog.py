"""Per-layer metric ``step_ms.backlog``: see ``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.step_ms(w)
