"""Plain PyTorch version of the paged decode kernel: the function of
``repro/models/attention.py::decode_attention_paged`` (n_splits = 1),
used by the tests and by CPU runs."""

from __future__ import annotations

import torch

__all__ = ["decode_attention_paged_reference"]

_NEG = -1e30


def decode_attention_paged_reference(q, k_pool, v_pool, block_tables,
                                     cache_len, *, window: int = 0):
    """q: (B, H, dh); k_pool/v_pool: (n_pages, page, KV, dh);
    block_tables: (B, P) int; cache_len: (B,) int.  ``window`` is a
    logical sliding window (positions in [cache_len - window, cache_len)).
    Gathers each row's logical cache through its table, then f32 scores,
    unnormalised exp and a late divide.  Returns (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    n_pages, page, kvh, _ = k_pool.shape
    rep = h // kvh
    p_max = block_tables.shape[1]
    s_log = p_max * page
    tok = (block_tables.long() * page)[:, :, None] \
        + torch.arange(page, device=q.device)[None, None, :]
    tok = tok.reshape(b, s_log)
    k = k_pool.reshape(n_pages * page, kvh, dh)[tok].float()  # (B, S, KV, dh)
    v = v_pool.reshape(n_pages * page, kvh, dh)[tok].float()
    qg = q.float().reshape(b, kvh, rep, dh)
    scores = torch.einsum("bkrd,bskd->bkrs", qg, k) * dh ** -0.5
    idx = torch.arange(s_log, device=q.device)
    cl = cache_len.long()
    valid = idx[None, :] < cl[:, None]                          # (B, S)
    if window > 0:
        valid &= idx[None, :] >= cl[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, _NEG))
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - m)
    out = torch.einsum("bkrs,bskd->bkrd", p, v)
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)
