"""Per-layer metric ``decode_attn_roofline.open``: see
``servebench/readers.py``."""

from servebench import readers


def read(w):
    return readers.decode_attn_roofline_pct(w)
