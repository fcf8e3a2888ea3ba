"""Per-layer metric ``step_ms.open``: see ``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.step_ms(w)
