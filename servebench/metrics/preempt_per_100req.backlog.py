"""Per-layer metric ``preempt_per_100req.backlog``: see
``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.preempt_per_100req(w)
