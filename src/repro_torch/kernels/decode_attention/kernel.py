"""ctypes binding of ``csrc/decode_attention.cu`` (replaces the Pallas
``repro/kernels/decode_attention/kernel.py::decode_attention_paged_kernel``)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["PAGED_DECODE_KERNEL"]

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# decode_attention_paged(q, k_pool, v_pool, tables, cache_len, out,
#                        B, H, KV, dh, page, P, window, scale, stream)
PAGED_DECODE_KERNEL = CudaKernel(
    "decode_attention", "decode_attention_paged",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _p])
