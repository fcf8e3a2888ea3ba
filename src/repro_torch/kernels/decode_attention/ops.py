"""Decode attention, paged (whole or partial) and dense: the hand-written
CUDA kernels (``csrc/decode_attention.cu``) for CUDA tensors, the plain
versions in ``ref.py`` for CPU tensors.

Paged and partial paged: as in the JAX ops, the block tables are padded to
a pow2 width with scratch page 0 first; the padded entries sit past every
row's ``cache_len`` and are masked.  Dense: the JAX op pads S_max to a
``block_s`` multiple for its grid; the CUDA kernel takes any S_max and
pads nothing (a pad would copy the whole cache on every call).

Every CUDA kernel here splits a row's keys across blocks: the grid is
(KV * n_groups, B, n_sub), ``split_kv_head_groups`` (paged and dense) or
``head_groups`` (partial) giving n_groups and ``split_kv_sub_splits``
n_sub, from shapes alone (never from cache_len, so that a CUDA graph
captured at one shape stays valid).  With n_sub > 1 the op allocates f32
scratch for the partials on the current stream and one C call launches
the split kernel and the merge kernel after it, counted as one launch.
All three cut every row at fixed boundaries from its first row
(``SPLIT_UNITS`` 64-row units a sub-split for the paged and dense
kernels, ``LSE_SPLIT_UNITS`` for the partial one), so their result for a
row never depends on the batch, the table's padded width or the card.
Where a kv head serves ``MMA_MIN_REP`` or more query heads, the paged and
dense kernels compute on the tensor cores and one block takes all of the
kv head's query heads (up to ``MMA_MAX_HEADS``).

None of the kernels has a backward, nor needs one (they serve one token
at a time): under autograd on the card each op raises
(``grad_guard.refuse_backward``, serving-only) rather than return a
detached tensor.
"""

from __future__ import annotations

import torch

from ..bucketing import pow2_bucket
from ..build import plain_here
from ..grad_guard import refuse_backward
from .kernel import DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL
from .ref import (decode_attention_dense_reference,
                  decode_attention_paged_lse_reference,
                  decode_attention_paged_reference)

__all__ = ["decode_attention_op", "decode_attention_paged_op",
           "decode_attention_paged_lse_op", "split_kv_sub_splits",
           "split_kv_head_groups", "uses_tensor_cores", "head_groups",
           "SPLIT_UNIT", "SPLIT_UNITS", "LSE_SPLIT_UNITS", "MMA_MIN_REP",
           "MMA_MAX_HEADS",
           "DENSE_DECODE_KERNEL", "PAGED_DECODE_KERNEL", "PAGED_LSE_KERNEL"]

_HEAD_DIMS = (64, 128, 192)
# a block's query heads * dh: 128 threads, 8 outputs each
_MAX_OUTPUTS = 1024
# the paged and dense kernels' tensor-core instance (csrc kMmaMinRep,
# kMmaMaxHeads): from this many query heads a kv head, at most this many
# heads a block
MMA_MIN_REP = 8
MMA_MAX_HEADS = 64
# the LSE kernel's page: its slots over one warp, two each
_LSE_MAX_PAGE = 64
# the split-KV kernels cut a row's keys into sub-splits of whole units of
# this many rows (their tiles are 64 rows, 32 at dh 192), SPLIT_UNITS each
# (tools/decode_split_tune.py times the choices on the card)
SPLIT_UNIT = 64
SPLIT_UNITS = 4
# the partial kernel's: one unit (its stripes are short: 256-row
# sub-splits left qwen2-1.5b's tp-4 stripe 32 blocks, 3.4x slower than
# one unit's 256 on an H100, tools/decode_split_tune.py)
LSE_SPLIT_UNITS = 1


def head_groups(rep: int, dh: int) -> tuple[int, int]:
    """The kernels' split of a kv head's ``rep`` query heads: the fewest
    equal groups of at most 1024 / dh heads, one block each.  Returns
    (n_groups, heads per group); the last group may have fewer."""
    max_heads = _MAX_OUTPUTS // dh
    n = -(-rep // max_heads)
    return n, -(-rep // n)


def uses_tensor_cores(rep: int) -> bool:
    """Whether the paged and dense kernels take a kv head's ``rep`` query
    heads to the tensor cores (mma.sync scores and value sums): from
    MMA_MIN_REP heads, where the f32 score dots pass the f32 cores'
    ridge."""
    return rep >= MMA_MIN_REP


def split_kv_head_groups(rep: int, dh: int) -> tuple[int, int]:
    """The paged and dense kernels' split of a kv head's ``rep`` query
    heads into blocks, (n_groups, heads per group): on the tensor cores
    the fewest equal groups of at most MMA_MAX_HEADS (one block a kv head
    up to 64 heads), else ``head_groups``."""
    if uses_tensor_cores(rep):
        n = -(-rep // MMA_MAX_HEADS)
        return n, -(-rep // n)
    return head_groups(rep, dh)


def split_kv_sub_splits(n_rows: int, units: int = SPLIT_UNITS) -> int:
    """Every decode kernel's sub-splits of a row's ``n_rows`` (P * page,
    S_max, or a stripe's P * page): ``units`` 64-row units each from the
    row's first, so the boundaries, and with them a row's result, never
    move with the batch, the table's padded width or the card; a
    sub-split past a row's live rows adds exact zeros in the merge."""
    return -(-n_rows // (units * SPLIT_UNIT))


def _scratch(n_sub: int, b: int, h: int, dh: int, dev) -> torch.Tensor:
    """f32 partials (m, l, acc) of every sub-split, or a placeholder."""
    return torch.empty((n_sub * b * h * (dh + 2) if n_sub > 1 else 1,),
                       dtype=torch.float32, device=dev)


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
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention_paged: {name} must be "
                             "16-byte aligned (the kernels copy 16-byte "
                             "chunks)")


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

    On CUDA everything is bf16 (q, pools, output), dh is 64, 128 or 192,
    any page size and H / KV are taken, and the result differs from the
    plain version only for a row with cache_len == 0, which the engine
    never passes (see ``csrc/decode_attention.cu``).  The kernel splits
    the P * page rows into sub-splits of ``SPLIT_UNITS`` 64-row units
    (scratch allocated here, two launches counted as one call); a row's
    result is the same for any table width and batch.  From MMA_MIN_REP
    query heads a kv head it computes on the tensor cores (value sums
    with p in two bf16 parts, as the flash kernel)."""
    refuse_backward("decode_attention_paged", q, k_pool, v_pool)
    block_tables = _pad_tables(block_tables)
    pb = block_tables.shape[1]
    dev = q.device
    if plain_here(dev):
        return decode_attention_paged_reference(
            q, k_pool, v_pool, block_tables, cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device {dev}")
    _check(q, k_pool, v_pool, block_tables, cache_len)
    b, h, dh = q.shape
    _, page, kvh, _ = k_pool.shape
    out = torch.empty_like(q)
    part = _scratch(split_kv_sub_splits(pb * page), b, h, dh, dev)
    PAGED_DECODE_KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_tables.data_ptr(), cache_len.data_ptr(),
                        out.data_ptr(), part.data_ptr(), b, h, kvh, dh, page,
                        pb, SPLIT_UNITS, int(window), dh ** -0.5,
                        torch.cuda.current_stream(dev).cuda_stream)
    PAGED_DECODE_KERNEL.launches += 1
    return out


def decode_attention_paged_lse_op(q, k_pool, v_pool, block_tables,
                                  cache_len, *, window: int = 0):
    """The partial paged decode over only the pages of ``block_tables``
    (operands as ``decode_attention_paged_op``; the tables may be a column
    stripe of a wider table).  Returns (out (B, H, dh) in q's dtype,
    normalised over those pages; lse (B, H) f32), the partial that
    ``models.attention.combine_lse_partials`` merges.

    On CUDA everything but lse is bf16, dh is 64, 128 or 192 and the
    page at most 64 slots; query heads beyond 1024 / dh per kv head go to
    further blocks (``head_groups``).  The kernel cuts the stripe's P *
    page rows into sub-splits of ``LSE_SPLIT_UNITS`` 64-row units
    (``split_kv_sub_splits``), so a row's (out, lse) is bit-identical for
    any batch and table width; with more than one, it writes f32 partials
    to scratch allocated here and a second, short kernel merges them in
    the same call (two launches, counted as one call in
    ``PAGED_LSE_KERNEL.launches``).  A row whose positions
    are all masked (cache_len 0, or every position before the window)
    gets out 0 from the kernel, where the plain version averages the
    row's values uniformly; both give lse = -1e30, which weighs it 0 in
    the merge (see ``csrc/decode_attention.cu``)."""
    refuse_backward("decode_attention_paged_lse", q, k_pool, v_pool)
    block_tables = _pad_tables(block_tables)
    dev = q.device
    if plain_here(dev):
        return decode_attention_paged_lse_reference(
            q, k_pool, v_pool, block_tables, cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_paged_lse: unsupported device "
                         f"{dev}")
    _check(q, k_pool, v_pool, block_tables, cache_len)
    b, h, dh = q.shape
    _, page, kvh, _ = k_pool.shape
    if page > _LSE_MAX_PAGE:
        raise ValueError(f"decode_attention_paged_lse: page {page} (at most "
                         f"{_LSE_MAX_PAGE})")
    p = block_tables.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev)
    part = _scratch(split_kv_sub_splits(p * page, LSE_SPLIT_UNITS), b, h,
                    dh, dev)
    PAGED_LSE_KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), cache_len.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), part.data_ptr(), b, h,
                     kvh, dh, page, p, LSE_SPLIT_UNITS, int(window),
                     dh ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
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
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned (the kernel loads 16-byte vectors)")


def decode_attention_op(q, k_cache, v_cache, cache_len, *,
                        window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); k_cache/v_cache: (B, S_max, KV, dh), ring buffers
    when ``window > 0``; cache_len (B,) int32.  Returns (B, H, dh) in q's
    dtype.

    On CUDA everything is bf16 (q, caches, output), dh is 64, 128 or 192
    and any S_max and H / KV are taken (``split_kv_head_groups`` splits
    the query heads into blocks, on the tensor cores from MMA_MIN_REP a kv
    head; the S_max rows are split into sub-splits of ``SPLIT_UNITS``
    64-row units).  The result differs from
    the plain version only for a row with cache_len == 0, which no caller
    passes (see ``csrc/decode_attention.cu``).  The ring rule (every slot valid
    once cache_len >= S_max) is the first min(cache_len, S_max) slots
    for any window, so the kernel takes no window: ``window`` changes no
    result and is accepted only for parity with the reference's
    signature."""
    refuse_backward("decode_attention", q, k_cache, v_cache)
    dev = q.device
    if plain_here(dev):
        return decode_attention_dense_reference(q, k_cache, v_cache,
                                                cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    _check_dense(q, k_cache, v_cache, cache_len)
    b, h, dh = q.shape
    _, s_max, kvh, _ = k_cache.shape
    out = torch.empty_like(q)
    part = _scratch(split_kv_sub_splits(s_max), b, h, dh, dev)
    DENSE_DECODE_KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        cache_len.data_ptr(), out.data_ptr(), part.data_ptr(),
                        b, h, kvh, dh, s_max, SPLIT_UNITS, dh ** -0.5,
                        torch.cuda.current_stream(dev).cuda_stream)
    DENSE_DECODE_KERNEL.launches += 1
    return out
