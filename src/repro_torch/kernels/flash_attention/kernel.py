"""ctypes binding of ``csrc/flash_attention.cu`` (replaces the Pallas
``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["FLASH_PREFILL_KERNEL"]

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# flash_attention_prefill(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV, dh,
#                         causal, window, scale, stream)
FLASH_PREFILL_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_prefill",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p])
