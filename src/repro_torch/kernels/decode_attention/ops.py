"""Decode attention, paged (whole or partial) and dense: the hand-written
CUDA kernels (``csrc/decode_attention.cu``) for CUDA tensors, the plain
versions in ``ref.py`` for CPU tensors.

Paged and partial paged: as in the JAX ops, the block tables are padded to
a pow2 width with scratch page 0 first; the padded entries sit past every
row's ``cache_len`` and are masked.  Dense: the JAX op pads S_max to a
``block_s`` multiple for its grid; the CUDA kernel takes any S_max and
pads nothing (a pad would copy the whole cache on every call).
"""

from __future__ import annotations

import torch

from ..bucketing import pow2_bucket
from .kernel import DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL
from .ref import (decode_attention_dense_reference,
                  decode_attention_paged_lse_reference,
                  decode_attention_paged_reference)

__all__ = ["decode_attention_op", "decode_attention_paged_op",
           "decode_attention_paged_lse_op", "lse_sub_splits",
           "DENSE_DECODE_KERNEL", "PAGED_DECODE_KERNEL", "PAGED_LSE_KERNEL"]

_HEAD_DIMS = (64, 128)
H100_SMS = 132
# the LSE kernel's limits: rep * dh outputs over 128 threads, 8 each; the
# page's slots over one warp, two each
_LSE_MAX_OUTPUTS = 1024
_LSE_MAX_PAGE = 64


def lse_sub_splits(b: int, kvh: int, n_pages: int,
                   sms: int = H100_SMS) -> int:
    """How many sub-splits the partial paged kernel cuts a call's
    ``n_pages`` table columns into, so that its b * kvh * n_sub blocks
    reach the card's ``sms`` where the pages allow: 1 when b * kvh blocks
    already fill the card, else ``ceil(n_pages / per)`` with per =
    ``n_pages // ceil(sms / (b * kvh))`` pages each (at least one).  The
    kernel gives sub-split z the columns [z * c, (z + 1) * c), c =
    ceil(n_pages / n_sub), which this count leaves non-empty; only a
    short row leaves some with no live position."""
    blocks = b * kvh
    if n_pages <= 1 or blocks >= sms:
        return 1
    per = max(1, n_pages // -(-sms // blocks))
    return -(-n_pages // per)


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


def _pad_tables(block_tables):
    """The tables padded to a pow2 width with scratch page 0 (a contiguous
    copy either way: a stripe of the tables is a column slice)."""
    p_max = block_tables.shape[1]
    pb = pow2_bucket(p_max)
    if pb != p_max:
        return torch.nn.functional.pad(block_tables, (0, pb - p_max))
    return block_tables.contiguous()


def decode_attention_paged_op(q, k_pool, v_pool, block_tables, cache_len, *,
                              window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); pools (n_pages, page, KV, dh); block_tables (B, P)
    int32; cache_len (B,) int32.  Returns (B, H, dh) in q's dtype.

    On CUDA everything is bf16 (q, pools, output) and the result differs
    from the plain version only for a row with cache_len == 0, which the
    engine never passes (see ``csrc/decode_attention.cu``)."""
    block_tables = _pad_tables(block_tables)
    pb = block_tables.shape[1]
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


def decode_attention_paged_lse_op(q, k_pool, v_pool, block_tables,
                                  cache_len, *, window: int = 0):
    """The partial paged decode over only the pages of ``block_tables``
    (operands as ``decode_attention_paged_op``; the tables may be a column
    stripe of a wider table).  Returns (out (B, H, dh) in q's dtype,
    normalised over those pages; lse (B, H) f32), the partial that
    ``models.attention.combine_lse_partials`` merges.

    On CUDA everything but lse is bf16, H / KV * dh is at most 1024 and
    the page at most 64 slots.  The kernel splits the table's columns
    over ``lse_sub_splits`` sub-splits per (kv head, row), for the card's
    SM count; with more than one, it writes f32 partials to scratch
    allocated here and a second, short kernel merges them in the same
    call (two launches, counted as one call in
    ``PAGED_LSE_KERNEL.launches``).  A row whose positions
    are all masked (cache_len 0, or every position before the window)
    gets out 0 from the kernel, where the plain version averages the
    row's values uniformly; both give lse = -1e30, which weighs it 0 in
    the merge (see ``csrc/decode_attention.cu``)."""
    block_tables = _pad_tables(block_tables)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_paged_lse_reference(
            q, k_pool, v_pool, block_tables, cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_paged_lse: unsupported device "
                         f"{dev}")
    _check(q, k_pool, v_pool, block_tables, cache_len)
    b, h, dh = q.shape
    _, page, kvh, _ = k_pool.shape
    if h // kvh * dh > _LSE_MAX_OUTPUTS or page > _LSE_MAX_PAGE:
        raise ValueError(f"decode_attention_paged_lse: H / KV * dh = "
                         f"{h // kvh * dh} (at most {_LSE_MAX_OUTPUTS}) and "
                         f"page {page} (at most {_LSE_MAX_PAGE})")
    p = block_tables.shape[1]
    n_sub = lse_sub_splits(
        b, kvh, p, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev)
    part = torch.empty((n_sub * b * h * (dh + 2) if n_sub > 1 else 1,),
                       dtype=torch.float32, device=dev)
    PAGED_LSE_KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), cache_len.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), part.data_ptr(), b, h,
                     kvh, dh, page, p, n_sub, int(window), dh ** -0.5,
                     torch.cuda.current_stream(dev).cuda_stream)
    PAGED_LSE_KERNEL.launches += 1
    return out, lse


def _check_dense(q, k_cache, v_cache, cache_len):
    dev = q.device
    b, h, dh = q.shape
    b2, s_max, kvh, dh2 = k_cache.shape
    if dh not in _HEAD_DIMS or dh2 != dh or b2 != b or h % kvh \
            or s_max < 1:
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} cache {tuple(k_cache.shape)} "
                         f"(head dim must be one of {_HEAD_DIMS}, H a "
                         f"multiple of KV, S_max >= 1)")
    if v_cache.shape != k_cache.shape or cache_len.shape != (b,):
        raise ValueError("decode_attention: mismatched shapes "
                         f"{tuple(v_cache.shape)} {tuple(cache_len.shape)}")
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_cache", k_cache, torch.bfloat16),
                           ("v_cache", v_cache, torch.bfloat16),
                           ("cache_len", cache_len, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a "
                             f"contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned (the kernel loads 16-byte vectors)")


def decode_attention_op(q, k_cache, v_cache, cache_len, *,
                        window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); k_cache/v_cache: (B, S_max, KV, dh), ring buffers
    when ``window > 0``; cache_len (B,) int32.  Returns (B, H, dh) in q's
    dtype.

    On CUDA everything is bf16 (q, caches, output), dh is 64 or 128 and
    any S_max and H / KV are taken (query heads beyond 1024 / dh per kv
    head go to further blocks).  The result differs from the plain
    version only for a row with cache_len == 0, which no caller passes
    (see ``csrc/decode_attention.cu``).  The ring rule (every slot valid
    once cache_len >= S_max) is the first min(cache_len, S_max) slots
    for any window, so the kernel takes no window: ``window`` changes no
    result and is accepted only for parity with the reference's
    signature."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_dense_reference(q, k_cache, v_cache,
                                                cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    _check_dense(q, k_cache, v_cache, cache_len)
    b, h, dh = q.shape
    _, s_max, kvh, _ = k_cache.shape
    out = torch.empty_like(q)
    DENSE_DECODE_KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        cache_len.data_ptr(), out.data_ptr(), b, h, kvh, dh,
                        s_max, dh ** -0.5,
                        torch.cuda.current_stream(dev).cuda_stream)
    DENSE_DECODE_KERNEL.launches += 1
    return out
