"""Paged decode attention: the hand-written CUDA kernel
(``csrc/decode_attention.cu``) for CUDA tensors, the plain version in
``ref.py`` for CPU tensors.

As in the JAX op, the block tables are padded to a pow2 width with
scratch page 0 first; the padded entries sit past every row's
``cache_len`` and are masked.
"""

from __future__ import annotations

import torch

from ..bucketing import pow2_bucket
from .kernel import PAGED_DECODE_KERNEL
from .ref import decode_attention_paged_reference

__all__ = ["decode_attention_paged_op", "PAGED_DECODE_KERNEL"]

_HEAD_DIMS = (64, 128)


def _check(q, k_pool, v_pool, block_tables, cache_len):
    dev = q.device
    b, h, dh = q.shape
    n_pages, page, kvh, dh2 = k_pool.shape
    if dh not in _HEAD_DIMS or dh2 != dh or h % kvh:
        raise ValueError(f"decode_attention_paged: unsupported shapes q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)} "
                         f"(head dim must be one of {_HEAD_DIMS})")
    if v_pool.shape != k_pool.shape or block_tables.shape[0] != b \
            or cache_len.shape != (b,):
        raise ValueError("decode_attention_paged: mismatched shapes "
                         f"{tuple(v_pool.shape)} {tuple(block_tables.shape)} "
                         f"{tuple(cache_len.shape)}")
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_pool", k_pool, torch.bfloat16),
                           ("v_pool", v_pool, torch.bfloat16),
                           ("block_tables", block_tables, torch.int32),
                           ("cache_len", cache_len, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"decode_attention_paged: {name} must be a "
                             f"contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")


def decode_attention_paged_op(q, k_pool, v_pool, block_tables, cache_len, *,
                              window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); pools (n_pages, page, KV, dh); block_tables (B, P)
    int32; cache_len (B,) int32.  Returns (B, H, dh) in q's dtype.

    On CUDA everything is bf16 (q, pools, output) and the result differs
    from the plain version only for a row with cache_len == 0, which the
    engine never passes (see ``csrc/decode_attention.cu``)."""
    p_max = block_tables.shape[1]
    pb = pow2_bucket(p_max)
    if pb != p_max:
        block_tables = torch.nn.functional.pad(block_tables,
                                               (0, pb - p_max))
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_paged_reference(
            q, k_pool, v_pool, block_tables, cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device {dev}")
    _check(q, k_pool, v_pool, block_tables, cache_len)
    b, h, dh = q.shape
    _, page, kvh, _ = k_pool.shape
    out = torch.empty_like(q)
    PAGED_DECODE_KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_tables.data_ptr(), cache_len.data_ptr(),
                        out.data_ptr(), b, h, kvh, dh, page, pb, int(window),
                        dh ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    PAGED_DECODE_KERNEL.launches += 1
    return out
