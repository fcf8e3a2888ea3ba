"""ctypes bindings of ``csrc/decode_attention.cu``: the paged kernel
(replaces the Pallas ``repro/kernels/decode_attention/kernel.py::
decode_attention_paged_kernel``), its partial (out, lse) variant
(replaces ``decode_attention_paged_lse_kernel``) and the dense-cache
kernel (replaces ``decode_attention_kernel``), each split across blocks
and each with its own launch count."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["PAGED_DECODE_KERNEL", "PAGED_LSE_KERNEL", "DENSE_DECODE_KERNEL"]

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# decode_attention_paged(q, k_pool, v_pool, tables, cache_len, out, part,
#                        B, H, KV, dh, page, P, per_units, window, scale,
#                        stream): the split kernel over sub-splits of
#                        per_units 64-row units and, where there is more
#                        than one, the merge kernel after it
PAGED_DECODE_KERNEL = CudaKernel(
    "decode_attention", "decode_attention_paged",
    [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p])

# decode_attention_paged_lse(q, k_pool, v_pool, tables, cache_len, out, lse,
#                            part, B, H, KV, dh, page, P, per_units, window,
#                            scale, stream): the split kernel over
#                            sub-splits of per_units 64-row units and,
#                            where there is more than one, the merge kernel
#                            after it
PAGED_LSE_KERNEL = CudaKernel(
    "decode_attention", "decode_attention_paged_lse",
    [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f,
     _p])

# decode_attention_dense(q, k_cache, v_cache, cache_len, out, part,
#                        B, H, KV, dh, S_max, per_units, scale, stream): as
#                        the paged entry point
DENSE_DECODE_KERNEL = CudaKernel(
    "decode_attention", "decode_attention_dense",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _p])
