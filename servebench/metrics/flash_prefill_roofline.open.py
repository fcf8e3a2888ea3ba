"""Per-layer metric ``flash_prefill_roofline.open``: see
``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.flash_prefill_roofline_pct(w)
