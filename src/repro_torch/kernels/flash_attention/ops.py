"""Prefill attention with explicit positions: the hand-written CUDA
kernels for CUDA tensors, the plain version in ``ref.py`` for CPU tensors.

A few bidirectional queries (at most ``SPLIT_MAX_SQ``, no causal mask and
no window: one decode step's cross-attention) split the keys across
blocks through the split-KV decode template (``csrc/decode_attention.cu``
``attention_short_queries``): the (query, head) pairs of a kv head become
its rows of query heads, every key row is masked by its position alone,
and the keys are cut at fixed ``SPLIT_UNITS`` 64-row units from key 0
(``flash_key_ranges``: from Sq and Sk alone, so a row's result never
follows the batch or the card); one C call launches the split and merge
kernels, counted as one launch of ``FLASH_SPLIT_KERNEL``.  Every other
call is one launch of the prefill kernel, ``FLASH_PREFILL_KERNEL``.
"""

from __future__ import annotations

import torch

from ..decode_attention.ops import SPLIT_UNITS, split_kv_sub_splits
from .kernel import FLASH_PREFILL_KERNEL, FLASH_SPLIT_KERNEL
from .ref import attention_reference

__all__ = ["flash_attention", "flash_key_ranges", "FLASH_PREFILL_KERNEL",
           "FLASH_SPLIT_KERNEL", "SPLIT_MAX_SQ"]

HEAD_DIMS = (64, 128, 192)    # the CUDA kernels' head dims
# the key split: at most this many queries (bidirectional, no window)
SPLIT_MAX_SQ = 16


def flash_key_ranges(sq: int, sk: int, *, causal: bool = False,
                     window: int = 0) -> int:
    """How many key ranges the flash op cuts a call's ``sk`` keys into: 0
    (no split: the prefill kernel) for more than SPLIT_MAX_SQ queries, a
    causal mask or a window; else the split-KV template's sub-splits of
    ``SPLIT_UNITS`` 64-row units from key 0 (1: one range, no merge) -- a
    function of Sq and Sk (and the mask's kind) alone, never of the batch,
    the heads or the card."""
    if sq > SPLIT_MAX_SQ or causal or window > 0:
        return 0
    return split_kv_sub_splits(sk)


def _check(q, k, v, positions, kv_positions):
    dev = q.device
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS or k.shape != (b, sk, kvh, dh) \
            or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head dim must be one of "
                         f"{HEAD_DIMS})")
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned (the kernel copies 16-byte chunks)")


def flash_attention(q, k, v, positions, kv_positions, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); positions (Sq,) and
    kv_positions (Sk,) int32, a negative kv position masking its row.
    Returns (B, Sq, H, dh) in q's dtype.

    On CUDA everything is bf16 with dh 64, 128 or 192, q, k and v 16-byte
    aligned.  The kernel's value product takes p as two bf16 parts (p to
    ~2^-16, where the plain version keeps f32 p); its result differs
    otherwise only for a query row that sees no key, which no caller
    makes (see ``csrc/flash_attention.cu``).  ``flash_key_ranges`` > 0
    takes the key split through the split-KV decode template (f32
    scratch allocated here; its rounding is the decode kernels'), where a
    query that sees no key gets 0."""
    dev = q.device
    if dev.type == "cpu":
        return attention_reference(q, k, v, positions, kv_positions,
                                   causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check(q, k, v, positions, kv_positions)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_ranges = flash_key_ranges(sq, sk, causal=causal, window=window)
    if n_ranges:
        # kv head g's rows of query heads: its (query, head) pairs, query
        # major (a copy only for Sq > 1)
        rep = h // kvh
        qh = q.reshape(b, sq, kvh, rep, dh).transpose(1, 2).reshape(
            b, kvh * sq * rep, dh).contiguous()
        out = torch.empty_like(qh)
        part = torch.empty((n_ranges * b * h * sq * (dh + 2)
                            if n_ranges > 1 else 1,),
                           dtype=torch.float32, device=dev)
        FLASH_SPLIT_KERNEL(qh.data_ptr(), k.data_ptr(), v.data_ptr(),
                           kv_positions.data_ptr(), out.data_ptr(),
                           part.data_ptr(), b, kvh * sq * rep, kvh, dh, sk,
                           SPLIT_UNITS, dh ** -0.5, stream)
        FLASH_SPLIT_KERNEL.launches += 1
        return out.reshape(b, kvh, sq, rep, dh).transpose(1, 2).reshape(
            b, sq, h, dh)
    out = torch.empty_like(q)
    FLASH_PREFILL_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         positions.data_ptr(), kv_positions.data_ptr(),
                         out.data_ptr(), b, sq, sk, h, kvh, dh, int(causal),
                         int(window), dh ** -0.5, stream)
    FLASH_PREFILL_KERNEL.launches += 1
    return out
