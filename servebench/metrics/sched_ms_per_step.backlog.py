"""Per-layer metric ``sched_ms_per_step.backlog``: see
``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.sched_ms_per_step(w)
