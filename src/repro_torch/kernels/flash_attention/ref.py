"""Plain PyTorch version of the prefill flash kernel: the function of
``repro/models/attention.py::gqa_attention`` with explicit query and key
positions, used by the tests and by CPU runs."""

from __future__ import annotations

import torch

__all__ = ["attention_reference"]

_NEG = -1e30


def attention_reference(q, k, v, positions, kv_positions, *,
                        causal: bool = True, window: int = 0):
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); positions: (Sq,);
    kv_positions: (Sk,), where a negative position masks its key row.
    f32 scores, masked at -1e30, unnormalised exp, late divide.  GQA by
    grouping query heads (no repeated K/V).  Returns (B, Sq, H, dh) in q's
    dtype."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.float().reshape(b, sq, kvh, rep, dh)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * dh ** -0.5
    qp = positions.long()[:, None]
    kp = kv_positions.long()[None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - m)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v.float())
    den = torch.clamp(p.sum(dim=-1), min=1e-30)               # (B, KV, rep, Sq)
    out = out / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)
