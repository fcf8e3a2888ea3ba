"""Plain PyTorch versions of the flash kernels: the prefill forward, the
function of ``repro/models/attention.py::gqa_attention`` with explicit
query and key positions (and, for training, its log-sum-exp), and its
backward, which the reference takes by XLA autodiff of that function, and
that backward as ``csrc/flash_attention_bwd.cu`` computes it
(``attention_backward_passes_reference``: P and dS as two bf16 parts each
in the value products).  Used by the tests and by CPU runs."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..bucketing import pow2_bucket

__all__ = ["attention_reference", "attention_backward_reference",
           "attention_backward_passes_reference"]

_NEG = -1e30
_LOG2E = 1.4426950408889634


def _padded_keys(k, v, kv_positions):
    """The key axis padded with masked zero rows to a power of two (at
    least 64): the CPU products then contract over the same length whether
    or not the caller padded its sequence, so a valid row's result does
    not depend on the end padding (the engine's pow2 prefill buckets), bit
    for bit."""
    sk = k.shape[1]
    pad = pow2_bucket(sk, floor=64) - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    return k, v, kv_positions


def _visible(positions, kv_positions, causal: bool, window: int):
    """(Sq, Sk) bool: key j visible to query i."""
    qp = positions.long()[:, None]
    kp = kv_positions.long()[None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    return mask


def _scores(qg, k, mask, scale: float):
    """qg: (B, Sq, KV, rep, dh) f32 -> masked scores (B, KV, rep, Sq, Sk)."""
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * scale
    return torch.where(mask, scores, torch.full_like(scores, _NEG))


def attention_reference(q, k, v, positions, kv_positions, *,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); positions: (Sq,);
    kv_positions: (Sk,), where a negative position masks its key row.
    f32 scores, masked at -1e30, unnormalised exp, late divide.  GQA by
    grouping query heads (no repeated K/V).  Returns (B, Sq, H, dh) in q's
    dtype and, with ``return_lse``, also the natural-log log-sum-exp of
    each row's scaled scores, (B, H, Sq) f32 (what the backward recomputes
    P from).  The key axis is padded first (``_padded_keys``)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    k, v, kv_positions = _padded_keys(k, v, kv_positions)
    rep = h // kvh
    qg = q.float().reshape(b, sq, kvh, rep, dh)
    scores = _scores(qg, k, _visible(positions, kv_positions, causal, window),
                     dh ** -0.5)
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - m)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v.float())
    den = torch.clamp(p.sum(dim=-1), min=1e-30)               # (B, KV, rep, Sq)
    out = out / den.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(b, sq, h, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = (m[..., 0] + torch.log(den)).reshape(b, h, sq)
    return out, lse


def attention_backward_reference(q, k, v, positions, kv_positions, out, lse,
                                 dout, *, causal: bool = True,
                                 window: int = 0):
    """The gradients (dq, dk, dv) of ``attention_reference`` at (q, k, v)
    for the output gradient ``dout`` (B, Sq, H, dh), from the forward's
    ``out`` and its ``lse`` (B, H, Sq), by the explicit formula in f32:
    P = exp(S scale - lse) (0 where masked), dV = P^T dO, dP = dO V^T,
    D = rowsum(dO * O), dS = P * (dP - D), dQ = dS K scale, dK = dS^T Q
    scale; dk and dv of a kv head are summed over its query heads.  The
    key axis is padded as in the forward and dk, dv cut back to Sk.
    Returns each in its input's dtype."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k, v, kv_positions = _padded_keys(k, v, kv_positions)
    rep = h // kvh
    scale = dh ** -0.5
    qg = q.float().reshape(b, sq, kvh, rep, dh)
    mask = _visible(positions, kv_positions, causal, window)
    scores = _scores(qg, k, mask, scale)                      # (B,KV,r,Sq,Sk)
    lse_g = lse.float().reshape(b, kvh, rep, sq, 1)
    p = torch.where(mask, torch.exp(scores - lse_g), torch.zeros_like(scores))
    do = dout.float().reshape(b, sq, kvh, rep, dh)
    dv = torch.einsum("bkrqs,bqkrd->bskd", p, do)
    dp = torch.einsum("bqkrd,bskd->bkrqs", do, v.float())
    d = (do * out.float().reshape(b, sq, kvh, rep, dh)).sum(-1)  # (B,Sq,KV,r)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkrqs,bskd->bqkrd", ds, k.float()) * scale
    dk = torch.einsum("bkrqs,bqkrd->bskd", ds, qg) * scale
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk[:, :sk].to(k.dtype),
            dv[:, :sk].to(v.dtype))


def _two_parts(t):
    """t as the sum of its two bf16 parts, hi + lo (exact in f32): the
    value that the kernel's two products of those parts take."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def attention_backward_passes_reference(q, k, v, positions, kv_positions,
                                        out, lse, dout, *,
                                        causal: bool = True,
                                        window: int = 0):
    """The gradients (dq, dk, dv) as ``csrc/flash_attention_bwd.cu``
    computes them, step by step in f32 from the inputs' values: D =
    rowsum(dO * O); the scores s of each visible (query, key) pair, P =
    exp2(s scale log2 e - lse log2 e) (0 where masked), dP = dO V^T, dS =
    P (dP - D) in f32; then the value products take P and dS as two bf16
    parts each (hi + lo, to ~2^-16), as the kernel's wgmma A operands: dV
    = (P_hi + P_lo)^T dO, dK = (dS_hi + dS_lo)^T Q scale, dQ = (dS_hi +
    dS_lo) K scale, f32 sums.  The kernel
    sums its 64-row tiles in its own fixed order; these f32 sums run in
    torch's, which differs only in f32 rounding.  Returns each in its
    input's dtype."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k, v, kv_positions = _padded_keys(k, v, kv_positions)
    rep = h // kvh
    scale = dh ** -0.5
    qg = q.float().reshape(b, sq, kvh, rep, dh)
    mask = _visible(positions, kv_positions, causal, window)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float())      # (B,KV,r,Sq,Sk)
    lse2 = lse.float().reshape(b, kvh, rep, sq, 1) * _LOG2E
    p = torch.where(mask, torch.exp2(s * (scale * _LOG2E) - lse2),
                    torch.zeros_like(s))
    do = dout.float().reshape(b, sq, kvh, rep, dh)
    d = (do * out.float().reshape(b, sq, kvh, rep, dh)).sum(-1)
    dp = torch.einsum("bqkrd,bskd->bkrqs", do, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    p1, ds1 = (_two_parts(t) for t in (p, ds))
    dv = torch.einsum("bkrqs,bqkrd->bskd", p1, do)
    dk = torch.einsum("bkrqs,bqkrd->bskd", ds1, qg) * scale
    dq = torch.einsum("bkrqs,bskd->bqkrd", ds1, k.float()) * scale
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk[:, :sk].to(k.dtype),
            dv[:, :sk].to(v.dtype))
