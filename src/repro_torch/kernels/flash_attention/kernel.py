"""ctypes bindings of the flash op's kernels: the prefill kernel
(``csrc/flash_attention.cu``, replaces the Pallas ``repro/kernels/
flash_attention/kernel.py::flash_attention_kernel``) in its serving
instance and in its training instance, which also writes each row's
log-sum-exp; for a few bidirectional queries, the split-KV decode template
with key positions (``csrc/decode_attention.cu``
``attention_short_queries``); and the backward kernel
(``csrc/flash_attention_bwd.cu``, which the Pallas package has no twin of:
the reference differentiates the jnp ``gqa_attention`` through XLA)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["FLASH_PREFILL_KERNEL", "FLASH_PREFILL_LSE_KERNEL",
           "FLASH_SPLIT_KERNEL", "FLASH_BACKWARD_KERNEL"]

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# flash_attention_prefill(q, k, v, qpos, kpos, out, B, Sq, Sk, H, KV, dh,
#                         causal, window, scale, stream)
FLASH_PREFILL_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_prefill",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p])

# flash_attention_prefill_lse(q, k, v, qpos, kpos, out, lse, B, Sq, Sk, H,
#                             KV, dh, causal, window, scale, stream)
FLASH_PREFILL_LSE_KERNEL = CudaKernel(
    "flash_attention", "flash_attention_prefill_lse",
    [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p])

# attention_short_queries(q, k, v, kpos, out, part, B, Hq, KV, dh, Sk,
#                         per_units, scale, stream): the keys split into
#                         sub-splits of per_units 64-row units from key 0,
#                         the merge kernel after the split kernel
FLASH_SPLIT_KERNEL = CudaKernel(
    "decode_attention", "attention_short_queries",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _p])

# flash_attention_backward(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv,
#                          dsum, part, B, Sq, Sk, H, KV, dh, causal, window,
#                          scale, stream): three kernels (D, dK/dV, dQ; with
#                          the head split's partials a fourth sums them),
#                          one call
FLASH_BACKWARD_KERNEL = CudaKernel(
    "flash_attention_bwd", "flash_attention_backward",
    [_p] * 13 + [_i] * 8 + [_f, _p])
