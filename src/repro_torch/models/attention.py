"""Attention entry points of the model, dispatching to the port's kernels.

``gqa_attention`` (prefill and chunked prefill) and ``encoder_attention``
(bidirectional encoder and cross attention) go to
``kernels.flash_attention``; ``decode_attention_paged`` (one decode token
over the paged pool) and ``decode_attention`` (one decode token over dense
per-row caches) to ``kernels.decode_attention``: the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.  The functions and layouts
are those of ``repro.models.attention``.
"""

from __future__ import annotations

import torch

from ..kernels.bucketing import pow2_bucket
from ..kernels.decode_attention.ops import (decode_attention_op,
                                            decode_attention_paged_lse_op,
                                            decode_attention_paged_op)
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["gqa_attention", "decode_attention", "decode_attention_paged",
           "encoder_attention", "combine_lse_partials"]

_NEG = -1e30


def combine_lse_partials(outs, lses, dim: int = 0):
    """Merge flash-style partial attention results along ``dim``.

    ``outs``: stacked *normalized* partial outputs with a trailing
    head_dim axis; ``lses``: the matching log-sum-exp values, shaped like
    ``outs`` minus that axis.  Returns (out, lse) of the softmax over the
    union of the stripes; an all-masked stripe (lse ~ -inf) weighs 0, and
    if every stripe is empty the merge returns 0, not NaN."""
    m = torch.clamp(lses.detach().amax(dim=dim, keepdim=True), min=_NEG)
    w = torch.exp(lses - m)
    den = torch.clamp(w.sum(dim=dim), min=1e-30)
    num = (outs * w.unsqueeze(-1)).sum(dim=dim)
    out = num / den.unsqueeze(-1)
    lse = m.squeeze(dim) + torch.log(den)
    return out, lse


def gqa_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  positions=None, kv_positions=None):
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh) with H % KV == 0.
    positions (Sq,) and kv_positions (Sk,) default as in the reference
    (iota; the key side reuses ``positions`` when Sk == Sq); a negative
    kv position masks its key row.  window > 0 enables sliding-window
    causal masking.  Returns (B, Sq, H, dh)."""
    sq, sk = q.shape[1], k.shape[1]
    if positions is None:
        positions = torch.arange(sq, device=q.device)
    if kv_positions is None:
        kv_positions = positions if sk == sq \
            else torch.arange(sk, device=q.device)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           positions.to(torch.int32).contiguous(),
                           kv_positions.to(torch.int32).contiguous(),
                           causal=causal, window=window)


def encoder_attention(q, k, v, *, kv_mask=None):
    """Bidirectional (encoder or cross) attention.  q: (B, Sq, H, dh);
    k, v: (B, Sk, KV, dh).  ``kv_mask`` is not supported, as in the
    reference: padding is the caller's, through kv positions."""
    if kv_mask is not None:
        raise ValueError("encoder_attention: kv_mask is not supported; use "
                         "kv_positions-based masking")
    return gqa_attention(q, k, v, causal=False)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """One-token decode attention over dense per-row caches.

    q: (B, 1, H, dh); k_cache/v_cache: (B, S_max, KV, dh), ring buffers
    when ``window > 0``; cache_len: (B,) valid tokens (for a ring, the
    write cursor: every slot is valid once cache_len >= S_max).  The
    valid slots are the first min(cache_len, S_max) for any ``window``,
    which is taken for parity with the reference's signature and changes
    no result.  Returns (B, 1, H, dh)."""
    b, _, h, dh = q.shape
    out = decode_attention_op(q.reshape(b, h, dh).contiguous(), k_cache,
                              v_cache, cache_len.to(torch.int32).contiguous(),
                              window=window)
    return out.reshape(b, 1, h, dh)


def decode_attention_paged(q, k_pool, v_pool, block_tables, cache_len, *,
                           window: int = 0, n_splits: int = 1,
                           stripe_pools=None):
    """One-token decode attention over a paged KV pool.

    q: (B, 1, H, dh); k_pool/v_pool: (n_pages, page, KV, dh), one pool
    shared by the batch; block_tables: (B, P) physical page of each
    logical page (page 0 is the engine's scratch page); cache_len: (B,)
    valid tokens.  ``window > 0`` is a logical sliding window.
    Returns (B, 1, H, dh).

    ``n_splits > 1`` is the LSE page split of tensor-parallel serving
    (``sharding.context.attn_split_count``, when the kv heads do not
    divide the mesh): stripe s owns the logical pages [s P/n, (s+1) P/n),
    runs the partial (out, lse) kernel over them with cache_len - s P/n
    page (clipped at 0; the window test shifts with it), and the stripes
    merge by ``combine_lse_partials``.  ``stripe_pools`` (optional) is one
    (k_pool, v_pool) pair per stripe: stripe s runs where its pair lives
    (shard s's device) and its partial comes back to q's device.

    P is padded with scratch page 0 to n_splits times a power of two, so
    every stripe is already on the op's pow2 ladder (the pad sits past
    every cache_len).  Each stripe is normalised before the merge, while
    the reference's jnp twin (``repro.models.attention.
    _decode_attention_paged_split``) merges unnormalised (m, l, acc): the
    same softmax in another reduction order, so the split is held to the
    unsplit result under the tolerance contract, not bit for bit."""
    b, _, h, dh = q.shape
    if n_splits > 1:
        out = _decode_attention_paged_split(
            q.reshape(b, h, dh), k_pool, v_pool, block_tables, cache_len,
            window=window, n_splits=n_splits, stripe_pools=stripe_pools)
        return out.reshape(b, 1, h, dh)
    out = decode_attention_paged_op(
        q.reshape(b, h, dh).contiguous(), k_pool, v_pool,
        block_tables.to(torch.int32).contiguous(),
        cache_len.to(torch.int32).contiguous(), window=window)
    return out.reshape(b, 1, h, dh)


def _decode_attention_paged_split(q, k_pool, v_pool, block_tables,
                                  cache_len, *, window: int, n_splits: int,
                                  stripe_pools):
    """q: (B, H, dh).  One partial kernel launch per stripe, merged on q's
    device.  Returns (B, H, dh) in q's dtype."""
    page = k_pool.shape[1]
    p_max = block_tables.shape[1]
    per = pow2_bucket(-(-p_max // n_splits))       # pages per stripe
    tables = block_tables.to(torch.int32)
    if per * n_splits != p_max:
        tables = torch.nn.functional.pad(tables,
                                         (0, per * n_splits - p_max))
    pools = stripe_pools or [(k_pool, v_pool)] * n_splits
    if len(pools) != n_splits:
        raise ValueError(f"decode_attention_paged: {len(pools)} stripe "
                         f"pools for {n_splits} stripes")
    cl = cache_len.to(torch.int32)
    outs, lses = [], []
    for s, (kp, vp) in enumerate(pools):
        dev = kp.device
        o, lse = decode_attention_paged_lse_op(
            q.to(dev).contiguous(), kp, vp,
            tables[:, s * per:(s + 1) * per].to(dev),
            torch.clamp(cl - s * per * page, min=0).to(dev).contiguous(),
            window=window)
        outs.append(o.to(q.device).float())
        lses.append(lse.to(q.device))
    out, _ = combine_lse_partials(torch.stack(outs), torch.stack(lses))
    return out.to(q.dtype)
