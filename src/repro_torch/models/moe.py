"""Mixture-of-Experts FFN with capacity-based dense dispatch (the port of
``repro.models.moe``).

Tokens are packed into a per-expert capacity buffer (E, C, D), the expert
FFNs run as batched GEMMs over it, and each token takes the K-way
gate-weighted sum of its experts' rows back.  Overflow beyond capacity is
dropped (Switch / GShard semantics); the router carries the Switch
load-balance loss.  Shared experts (DeepSeek-MoE) run as one always-on
MLP beside the routed ones.

Every shape follows from N, K, E and C alone and nothing reads a value
back to the host (no boolean-mask indexing, ``nonzero`` or ``.item()``),
so the decode steps that run this FFN can be captured as CUDA graphs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.context import constrain_expert_buf
from .layers import ParamSpec, mlp, mlp_template

__all__ = ["moe_template", "moe_ffn", "moe_route", "moe_combine",
           "expert_mlp", "expert_group", "capacity"]

# the widest expert-parallel plan whose shards hold whole GEMM groups
# (``expert_group``)
_MAX_EXPERT_TP = 8


def moe_template(cfg, layers: int | None = None):
    D, E, DF = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    L = (layers,) if layers is not None else ()
    la = ("layers",) if layers is not None else ()
    t = {
        "router": ParamSpec(L + (D, E), torch.float32,
                            la + ("embed", "router")),
        "w_in": ParamSpec(L + (E, D, DF), torch.bfloat16,
                          la + ("expert", "embed", "expert_mlp")),
        "w_out": ParamSpec(L + (E, DF, D), torch.bfloat16,
                           la + ("expert", "expert_mlp", "embed")),
    }
    if cfg.activation == "swiglu":
        t["w_gate"] = ParamSpec(L + (E, D, DF), torch.bfloat16,
                                la + ("expert", "embed", "expert_mlp"))
    if cfg.n_shared_experts > 0:
        t["shared"] = mlp_template(D, cfg.n_shared_experts * DF,
                                   cfg.activation, layers)
    return t


def capacity(cfg, n_tokens: int, *, decode: bool) -> int:
    """Rows an expert's buffer holds: every assignment at decode (nothing
    drops), else ``min(N K, max(1, int(N K capacity_factor / E)))``."""
    nk = n_tokens * cfg.experts_per_token
    if decode:
        return nk
    return min(nk, max(1, int(nk * cfg.capacity_factor / cfg.n_experts)))


def expert_group(n_experts: int) -> int:
    """Experts per batched GEMM call.  Every path runs its expert products
    in calls of this many experts, so a shard of an expert-parallel plan
    (E / tp experts, tp up to 8 dividing E) makes calls of the same shape
    as one device does, and cuBLAS picks the same algorithm for both."""
    return n_experts // math.gcd(n_experts, _MAX_EXPERT_TP)


def expert_mlp(params, buf, activation: str, group: int):
    """buf: (e, C, D) -> (e, C, D) through the experts in ``params``
    (their leading dim is e), ``group`` experts a GEMM call."""
    outs = []
    for g in range(0, buf.shape[0], group):
        b = buf[g:g + group]
        w = {k: params[k][g:g + group]
             for k in ("w_in", "w_gate", "w_out") if k in params}
        h_in = torch.bmm(b, w["w_in"])
        if activation == "swiglu":
            h = F.silu(torch.bmm(b, w["w_gate"])) * h_in
        elif activation == "squared_relu":
            h = F.relu(h_in).square()
        elif activation == "gelu":
            h = F.gelu(h_in, approximate="tanh")
        else:
            raise ValueError(f"unknown activation {activation!r}")
        outs.append(torch.bmm(h, w["w_out"]))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def moe_route(params, xf, cfg, *, decode: bool):
    """Router, top-K and dispatch of xf (N, D).  Returns (buf (E, C, D),
    row, w, aux): the flat buffer row of each (token, k) assignment (N K,)
    and its gate weight (0 where dropped), which the combine takes, and the
    load-balance loss."""
    N, D = xf.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, N, decode=decode)
    logits = xf.float() @ params["router"]                    # (N, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower expert
    # first, as jax.lax.top_k orders them
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # each assignment's rank within its expert, in (token, k) order
    eflat = top_i.reshape(-1)                                 # (N K,)
    experts = torch.arange(E, device=xf.device)
    onehot = (eflat[:, None] == experts).to(torch.int32)      # (N K, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot              # exclusive
    pos = ranks.gather(1, eflat[:, None])[:, 0]
    keep = pos < C
    row = eflat * C + torch.where(keep, pos, torch.zeros_like(pos))

    # every kept row is unique; dropped assignments land in a last row
    # that is cut off
    src = xf[:, None, :].expand(N, K, D).reshape(N * K, D)
    buf = torch.zeros((E * C + 1, D), dtype=xf.dtype, device=xf.device)
    buf[torch.where(keep, row, torch.full_like(row, E * C))] = src
    w = gates.reshape(-1) * keep

    # Switch load-balance loss: E * sum_e f_e * p_e (f_e of the top-1)
    frac = (top_i[:, :1] == experts).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0)) * cfg.router_aux_weight
    return buf[:E * C].view(E, C, D), row, w, aux


def moe_combine(out_buf, row, w, n_tokens: int, k: int):
    """The K-way gate-weighted sum of each token's expert rows: (N, D)."""
    flat = out_buf.reshape(-1, out_buf.shape[-1])
    picked = flat.index_select(0, row)                        # (N K, D)
    weighted = picked * w.to(picked.dtype)[:, None]
    return weighted.view(n_tokens, k, -1).sum(dim=1)


def moe_ffn(params, x, cfg, *, decode: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux loss f32 scalar).

    ``decode=True`` gives every assignment capacity (no token drops):
    decode batches are small and a drop there corrupts generation."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    buf, row, w, aux = moe_route(params, xf, cfg, decode=decode)
    buf, = constrain_expert_buf(buf)
    out_buf, = constrain_expert_buf(expert_mlp(
        params, buf, cfg.activation, expert_group(cfg.n_experts)))
    out = moe_combine(out_buf, row, w, B * S, cfg.experts_per_token)
    if cfg.n_shared_experts > 0:
        out = out + mlp(params["shared"], xf, cfg.activation)
    return out.reshape(B, S, D), aux
