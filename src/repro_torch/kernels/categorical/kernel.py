"""ctypes binding of ``csrc/categorical.cu``: the fused step's sampled draw
(threefry2x32 ``fold_in`` and Gumbel-max ``categorical``), which the
reference draws through XLA (``repro/serving/engine.py:304-316``; no
Pallas kernel)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["CATEGORICAL_KERNEL"]

_p, _i, _l, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint

# categorical_sample(logits, is_bf16, ld, temps, greedy, seeds, counters,
#                    base0, base1, partials, blocks, value, index, lanes,
#                    n, offset, stream): one launch (the column blocks of
#                    each lane, the last of which merges them)
CATEGORICAL_KERNEL = CudaKernel(
    "categorical", "categorical_sample",
    [_p, _i, _l, _p, _p, _p, _p, _u, _u, _p, _i, _p, _p, _i, _i, _l, _p])
