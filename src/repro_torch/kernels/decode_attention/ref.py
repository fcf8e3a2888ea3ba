"""Plain PyTorch versions of the decode kernels, used by the tests and by
CPU runs: the functions of ``repro/models/attention.py::
decode_attention_paged`` (n_splits = 1) and ``decode_attention`` (dense,
possibly ring-buffer caches), the partial ``(out, lse)`` paged decode of
``repro/kernels/decode_attention/ref.py::
decode_attention_paged_lse_reference``, and the counterpart of the JAX
package's dense oracle ``decode_attention_reference``, which normalises
before the value sum."""

from __future__ import annotations

import torch

__all__ = ["decode_attention_paged_reference",
           "decode_attention_paged_lse_reference",
           "decode_attention_dense_reference", "decode_attention_reference"]

_NEG = -1e30


def _paged_scores(q, k_pool, v_pool, block_tables, cache_len, window: int):
    """Each row's logical cache gathered through its table: f32 scores
    (B, KV, rep, S) scaled by dh^-1/2, positions outside [cache_len -
    window, cache_len) (the lower bound only with a window) at -1e30,
    and the gathered values (B, S, KV, dh) in f32."""
    b, h, dh = q.shape
    n_pages, page, kvh, _ = k_pool.shape
    s_log = block_tables.shape[1] * page
    tok = (block_tables.long() * page)[:, :, None] \
        + torch.arange(page, device=q.device)[None, None, :]
    tok = tok.reshape(b, s_log)
    k = k_pool.reshape(n_pages * page, kvh, dh)[tok].float()  # (B, S, KV, dh)
    v = v_pool.reshape(n_pages * page, kvh, dh)[tok].float()
    qg = q.float().reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bkrd,bskd->bkrs", qg, k) * dh ** -0.5
    idx = torch.arange(s_log, device=q.device)
    cl = cache_len.long()
    valid = idx[None, :] < cl[:, None]                          # (B, S)
    if window > 0:
        valid &= idx[None, :] >= cl[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, _NEG))
    return scores, v


def decode_attention_paged_reference(q, k_pool, v_pool, block_tables,
                                     cache_len, *, window: int = 0):
    """q: (B, H, dh); k_pool/v_pool: (n_pages, page, KV, dh);
    block_tables: (B, P) int; cache_len: (B,) int.  ``window`` is a
    logical sliding window (positions in [cache_len - window, cache_len)).
    Gathers each row's logical cache through its table, then f32 scores,
    unnormalised exp and a late divide.  Returns (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    scores, v = _paged_scores(q, k_pool, v_pool, block_tables, cache_len,
                              window)
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - m)
    out = torch.einsum("bkrs,bskd->bkrd", p, v)
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def decode_attention_paged_lse_reference(q, k_pool, v_pool, block_tables,
                                         cache_len, *, window: int = 0):
    """The partial paged decode over only the pages of this call's tables:
    operands as ``decode_attention_paged_reference``.  Returns (out
    (B, H, dh) in q's dtype, normalised over those pages; lse (B, H) f32
    = m + log(max(l, 1e-30))), the partial that ``models.attention.
    combine_lse_partials`` merges across page stripes.  As in the
    reference, a call whose positions are all masked averages its values
    uniformly and gives lse = -1e30 (+ log of the position count, which
    f32 does not resolve), so its merge weight is exactly 0."""
    b, h, dh = q.shape
    scores, v = _paged_scores(q, k_pool, v_pool, block_tables, cache_len,
                              window)
    m = scores.max(dim=-1).values                               # (B, KV, rep)
    p = torch.exp(scores - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bkrs,bskd->bkrd", p / l[..., None], v)
    return (out.reshape(b, h, dh).to(q.dtype),
            (m + torch.log(l)).reshape(b, h))


def _dense_scores(q, k_cache, cache_len, window: int):
    """f32 scores (B, KV, rep, S_max) of q against the dense cache, slots
    outside the valid set at -1e30.  Slot idx is valid iff idx <
    cache_len or, for a ring buffer (window > 0), cache_len >= S_max:
    once wrapped every slot holds one of the last S_max tokens.  The
    second term is the reference's mask, written as it is there; it
    changes no result (idx < cache_len already holds for every slot once
    cache_len >= S_max), so ``window`` is accepted here, and by the
    functions below and ``decode_attention_op``, only for parity with the
    reference's signature.  Only the ring's write index depends on it
    (``models.transformer._attn_decode``)."""
    b, h, dh = q.shape
    _, s_max, kvh, _ = k_cache.shape
    qg = q.float().reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bkrd,bskd->bkrs", qg, k_cache.float()) \
        * dh ** -0.5
    idx = torch.arange(s_max, device=q.device)
    cl = cache_len.long()
    valid = idx[None, :] < cl[:, None]                          # (B, S)
    if window > 0:
        valid = valid | (cl[:, None] >= s_max)
    return torch.where(valid[:, None, None, :], scores,
                       torch.full_like(scores, _NEG))


def decode_attention_dense_reference(q, k_cache, v_cache, cache_len, *,
                                     window: int = 0):
    """The model's dense decode attention (what ``Model.decode_step``
    runs): q (B, H, dh); k_cache/v_cache (B, S_max, KV, dh); cache_len
    (B,) int.  f32 scores, unnormalised exp, f32 p into the value sum and
    one late divide by max(l, 1e-30).  Returns (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    scores = _dense_scores(q, k_cache, cache_len, window)
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - m)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def decode_attention_reference(q, k_cache, v_cache, cache_len, *,
                               window: int = 0):
    """Counterpart of the JAX package's dense oracle: the same masked
    scores, but p normalised before the value sum.  Returns (B, H, dh)
    in q's dtype."""
    b, h, dh = q.shape
    scores = _dense_scores(q, k_cache, cache_len, window)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)
