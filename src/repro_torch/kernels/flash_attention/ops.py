"""Prefill attention with explicit positions: the hand-written CUDA
kernel (``csrc/flash_attention.cu``) for CUDA tensors, the plain version
in ``ref.py`` for CPU tensors."""

from __future__ import annotations

import torch

from .kernel import FLASH_PREFILL_KERNEL
from .ref import attention_reference

__all__ = ["flash_attention", "FLASH_PREFILL_KERNEL"]

HEAD_DIM = 64        # the CUDA kernel's head dim (llama3.2-1b)


def _check(q, k, v, positions, kv_positions):
    dev = q.device
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if dh != HEAD_DIM or k.shape != (b, sk, kvh, dh) or v.shape != k.shape \
            or h % kvh:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head dim must be {HEAD_DIM})")
    if positions.shape != (sq,) or kv_positions.shape != (sk,):
        raise ValueError(f"flash_attention: positions {tuple(positions.shape)}"
                         f" / kv_positions {tuple(kv_positions.shape)} do not "
                         f"match Sq={sq}, Sk={sk}")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16),
                           ("positions", positions, torch.int32),
                           ("kv_positions", kv_positions, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")


def flash_attention(q, k, v, positions, kv_positions, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); positions (Sq,) and
    kv_positions (Sk,) int32, a negative kv position masking its row.
    Returns (B, Sq, H, dh) in q's dtype.

    On CUDA everything is bf16 with dh = 64; the result differs from the
    plain version only for a query row that sees no key, which no caller
    makes (see ``csrc/flash_attention.cu``)."""
    dev = q.device
    if dev.type == "cpu":
        return attention_reference(q, k, v, positions, kv_positions,
                                   causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check(q, k, v, positions, kv_positions)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    FLASH_PREFILL_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         positions.data_ptr(), kv_positions.data_ptr(),
                         out.data_ptr(), b, sq, sk, h, kvh, dh, int(causal),
                         int(window), dh ** -0.5,
                         torch.cuda.current_stream(dev).cuda_stream)
    FLASH_PREFILL_KERNEL.launches += 1
    return out
