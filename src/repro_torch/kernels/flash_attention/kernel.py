"""ctypes bindings of the flash op's kernels: the prefill kernel
(``csrc/flash_attention.cu``, replaces the Pallas ``repro/kernels/
flash_attention/kernel.py::flash_attention_kernel``) and, for a few
bidirectional queries, the split-KV decode template with key positions
(``csrc/decode_attention.cu`` ``attention_short_queries``)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["FLASH_PREFILL_KERNEL", "FLASH_SPLIT_KERNEL"]

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# flash_attention_prefill(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV, dh,
#                         causal, window, scale, stream)
FLASH_PREFILL_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_prefill",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p])

# attention_short_queries(q, k, v, kpos, out, part, B, Hq, KV, dh, Sk,
#                         per_units, scale, stream): the keys split into
#                         sub-splits of per_units 64-row units from key 0,
#                         the merge kernel after the split kernel
FLASH_SPLIT_KERNEL = CudaKernel(
    "decode_attention", "attention_short_queries",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _p])
