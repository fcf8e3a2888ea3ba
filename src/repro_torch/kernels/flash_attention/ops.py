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

Under autograd (grad enabled and q, k or v requiring grad) the op goes
through ``FlashAttentionFunction`` instead: its forward is one launch of
the prefill kernel's training instance, ``FLASH_PREFILL_LSE_KERNEL``
(which also writes each row's log-sum-exp; never the key split), and its
backward one call of ``FLASH_BACKWARD_KERNEL`` (``csrc/
flash_attention_bwd.cu``: D, then dK/dV (its heads split over two blocks
on a small grid, ``backward_head_split``, and the halves summed), then
dQ, counted as one launch).
On the CPU the same Function runs the plain versions
(``attention_reference(return_lse=True)``,
``attention_backward_reference``), so only the kernels differ.  A build
or launch error raises; nothing falls back.
"""

from __future__ import annotations

import torch

from ..build import plain_here
from ..decode_attention.ops import SPLIT_UNITS, split_kv_sub_splits
from .kernel import (FLASH_BACKWARD_KERNEL, FLASH_PREFILL_KERNEL,
                     FLASH_PREFILL_LSE_KERNEL, FLASH_SPLIT_KERNEL)
from .ref import attention_backward_reference, attention_reference

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_backward",
           "FlashAttentionFunction", "flash_key_ranges", "backward_head_split",
           "FLASH_PREFILL_KERNEL", "FLASH_PREFILL_LSE_KERNEL",
           "FLASH_SPLIT_KERNEL", "FLASH_BACKWARD_KERNEL", "SPLIT_MAX_SQ"]

HEAD_DIMS = (64, 128, 192)    # the CUDA kernels' head dims
# the key split: at most this many queries (bidirectional, no window)
SPLIT_MAX_SQ = 16
# the backward's dK/dV pass splits its query heads below this many blocks
# (two an SM of the H100's 132: a smaller causal grid waits on its longest
# key tile)
HEAD_SPLIT_BELOW = 264


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


def backward_head_split(b: int, sk: int, h: int, kvh: int) -> bool:
    """Whether the backward kernel's dK/dV pass splits each kv head's query
    heads over two blocks (f32 partials, summed after the pass in a fixed
    order): where its grid of (64-row key tile, kv head, batch row) blocks
    is under HEAD_SPLIT_BELOW and the heads split evenly.  A function of
    the shapes alone, never of the card."""
    return (h // kvh) % 2 == 0 and -(-sk // 64) * kvh * b < HEAD_SPLIT_BELOW


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, positions, kv_positions,
                                            causal, window)
    dev = q.device
    if plain_here(dev):
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


def flash_attention_lse(q, k, v, positions, kv_positions, *,
                        causal: bool = True, window: int = 0):
    """The training forward: (out (B, Sq, H, dh) in q's dtype, lse (B, H,
    Sq) f32, each row's natural-log log-sum-exp of its scaled scores).  On
    CUDA one launch of the prefill kernel's LSE instance (whatever Sq: no
    key split), whose ``out`` is bit-identical to the serving instance's;
    on the CPU ``attention_reference(return_lse=True)``."""
    dev = q.device
    if plain_here(dev):
        return attention_reference(q, k, v, positions, kv_positions,
                                   causal=causal, window=window,
                                   return_lse=True)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_lse: unsupported device {dev}")
    _check(q, k, v, positions, kv_positions)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    FLASH_PREFILL_LSE_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             positions.data_ptr(), kv_positions.data_ptr(),
                             out.data_ptr(), lse.data_ptr(), b, sq, sk, h,
                             kvh, dh, int(causal), int(window), dh ** -0.5,
                             torch.cuda.current_stream(dev).cuda_stream)
    FLASH_PREFILL_LSE_KERNEL.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, positions, kv_positions, out, lse,
                             dout, *, causal: bool = True, window: int = 0):
    """(dq, dk, dv) of the flash op at (q, k, v) for the output gradient
    ``dout``, from the training forward's ``out`` and ``lse``
    (``flash_attention_lse``).  On CUDA one call of the backward kernel
    (bf16 in and out, f32 accumulators; deterministic: no atomics), on the
    CPU ``attention_backward_reference``."""
    dev = q.device
    if plain_here(dev):
        return attention_backward_reference(q, k, v, positions, kv_positions,
                                            out, lse, dout, causal=causal,
                                            window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_backward: unsupported device "
                         f"{dev}")
    _check(q, k, v, positions, kv_positions)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (("out", out, q.shape, torch.bfloat16),
                                  ("dout", dout, q.shape, torch.bfloat16),
                                  ("lse", lse, (b, h, sq), torch.float32)):
        if t.shape != shape or t.device != dev or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_backward: {name} must be a "
                             f"contiguous, 16-byte aligned {dtype} tensor of "
                             f"shape {tuple(shape)} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    part = (torch.empty((2, 2, b, sk, kvh, dh), dtype=torch.float32,
                        device=dev)
            if backward_head_split(b, sk, h, kvh) else None)
    FLASH_BACKWARD_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          positions.data_ptr(), kv_positions.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          dsum.data_ptr(),
                          None if part is None else part.data_ptr(), b, sq,
                          sk, h, kvh, dh, int(causal), int(window),
                          dh ** -0.5,
                          torch.cuda.current_stream(dev).cuda_stream)
    FLASH_BACKWARD_KERNEL.launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """The flash op under autograd: ``flash_attention_lse`` forward (O and
    the LSE saved with q, k, v and the positions), ``flash_attention_
    backward`` backward.  The positions, ``causal`` and ``window`` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, positions, kv_positions, causal, window):
        out, lse = flash_attention_lse(q, k, v, positions, kv_positions,
                                       causal=causal, window=window)
        ctx.save_for_backward(q, k, v, positions, kv_positions, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, positions, kv_positions, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, positions, kv_positions, out, lse,
            dout.to(q.dtype).contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None, None, None
