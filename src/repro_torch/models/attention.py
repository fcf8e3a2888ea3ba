"""Attention entry points of the model, dispatching to the port's kernels.

``gqa_attention`` (prefill and chunked prefill) goes to
``kernels.flash_attention`` and ``decode_attention_paged`` (one decode
token over the paged pool) to ``kernels.decode_attention``: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.  The
functions and layouts are those of ``repro.models.attention``.
"""

from __future__ import annotations

import torch

from ..kernels.decode_attention.ops import decode_attention_paged_op
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["gqa_attention", "decode_attention_paged", "combine_lse_partials"]

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


def decode_attention_paged(q, k_pool, v_pool, block_tables, cache_len, *,
                           window: int = 0, n_splits: int = 1):
    """One-token decode attention over a paged KV pool.

    q: (B, 1, H, dh); k_pool/v_pool: (n_pages, page, KV, dh), one pool
    shared by the batch; block_tables: (B, P) physical page of each
    logical page (page 0 is the engine's scratch page); cache_len: (B,)
    valid tokens.  ``window > 0`` is a logical sliding window.
    Returns (B, 1, H, dh)."""
    if n_splits != 1:
        raise NotImplementedError(
            "decode_attention_paged: n_splits > 1 (the LSE page split of "
            "tensor-parallel serving) is ROADMAP Queue A 10")
    b, _, h, dh = q.shape
    out = decode_attention_paged_op(
        q.reshape(b, h, dh).contiguous(), k_pool, v_pool,
        block_tables.to(torch.int32).contiguous(),
        cache_len.to(torch.int32).contiguous(), window=window)
    return out.reshape(b, 1, h, dh)
