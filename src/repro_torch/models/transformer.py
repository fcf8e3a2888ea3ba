"""Decoder-only transformer, dense GQA family: full-sequence forward,
paged decode step and chunked prefill, as plain functions over a params
dict with the reference's stacked ``(L, ...)`` layout and tree keys
(``repro.models.transformer``).  Layers run as a Python loop over the
stacked axis.  The reference's sharding hooks (``repro.sharding.context``)
are the identity on one card and are left out.

Other families are not ported yet: building them raises
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from .attention import decode_attention_paged, gqa_attention
from .config import ModelConfig
from .layers import (ParamSpec, apply_rope, attention_template, linear, mlp,
                     mlp_template, norm_template, rms_norm)

__all__ = ["decoder_template", "decoder_forward", "decoder_decode_step_paged",
           "decoder_prefill_chunk", "paged_cache_shapes", "require_ported"]

_NOT_PORTED = {
    "moe": "ROADMAP Queue A 6 (MoE and VLM families)",
    "vlm": "ROADMAP Queue A 6 (MoE and VLM families)",
    "ssm": "ROADMAP Queue A 7 (SSM and hybrid)",
    "hybrid": "ROADMAP Queue A 7 (SSM and hybrid)",
    "encdec": "ROADMAP Queue A 12 (encoder-decoder)",
}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet ({_NOT_PORTED.get(cfg.family, 'ROADMAP')})")


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``(L, ...)`` parameter subtree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attention_kind == "sliding_window" else 0


# ------------------------------------------------------------------ template

def decoder_template(cfg: ModelConfig):
    require_ported(cfg)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    t = {
        "embed": ParamSpec((V, D), torch.bfloat16),
        "final_norm": norm_template(D),
        "layers": {"ln1": norm_template(D, L), "ln2": norm_template(D, L),
                   "attn": attention_template(cfg, L),
                   "mlp": mlp_template(D, cfg.d_ff, cfg.activation, L)},
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((D, V), torch.bfloat16)
    return t


def _qkv(cfg, p, x, positions):
    """Projected and rope'd q (B,S,H,dh), k and v (B,S,KV,dh)."""
    b, s, _ = x.shape
    q = linear(p["wq"], x, p.get("bq")).reshape(b, s, cfg.n_heads,
                                                 cfg.head_dim)
    k = linear(p["wk"], x, p.get("bk")).reshape(b, s, cfg.n_kv_heads,
                                                 cfg.head_dim)
    v = linear(p["wv"], x, p.get("bv")).reshape(b, s, cfg.n_kv_heads,
                                                 cfg.head_dim)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _wo_proj(p, o):
    """o: (B, S, H, dh) -> (B, S, D).  One GEMM over H * dh; the reference
    sums f32 per-kv-group partials and rounds once, which is the same sum
    in another order."""
    b, s, h, dh = o.shape
    return linear(p["wo"], o.reshape(b, s, h * dh))


def _logits(params, cfg, h):
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


# ------------------------------------------------------- sequence forward

def decoder_forward(params, cfg: ModelConfig, tokens, positions=None, *,
                    collect_cache: bool = False):
    """Full-sequence forward (prefill).  tokens: (B, S) int.
    Returns (logits (B, S, V), cache or None, aux loss 0).  The cache is
    {"k", "v"}: (L, B, S, KV, dh) in the compute dtype."""
    require_ported(cfg)
    h = params["embed"][tokens.long()]
    s = h.shape[1]
    if positions is None:
        positions = torch.arange(s, device=h.device)
    window = _window(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _qkv(cfg, lp["attn"],
                       rms_norm(lp["ln1"], h, cfg.norm_eps), positions)
        o = gqa_attention(q, k, v, causal=True, window=window,
                          positions=positions)
        h = h + _wo_proj(lp["attn"], o)
        h = h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                    cfg.activation)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    logits = _logits(params, cfg, h)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if collect_cache else None
    return logits, cache, torch.zeros((), device=h.device)


# ---------------------------------------------------------- paged serving

def paged_cache_shapes(cfg: ModelConfig, n_pages: int, page_size: int,
                       n_slots: int):
    """{name: (shape, dtype)} of the paged KV pool: one
    (L, n_pages, page, KV, dh) bf16 pool for K and one for V, shared by
    the batch through block tables (page 0 is the engine's scratch page).
    ``n_slots`` sizes per-slot state, which the dense family has none of."""
    require_ported(cfg)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def _attn_decode_paged(cfg, p, x, k_pool, v_pool, cache_len, block_tables,
                       *, window: int, page: int):
    """x: (B,1,D); pools (n_pages, page, KV, dh) of one layer.  Writes this
    step's KV at each row's logical position through its block table
    (inactive rows point at the scratch page), then attends with
    ``cache_len + 1``."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, cache_len[:, None])
    logical = cache_len.long()
    page_idx = torch.clamp(logical // page, max=block_tables.shape[1] - 1)
    phys = block_tables[torch.arange(b, device=x.device), page_idx].long() \
        * page + logical % page
    # in place: the step's K/V land straight in the shared pool instead of
    # a functional update that would copy the layer's whole pool
    kvh, dh = k_pool.shape[2:]
    k_pool.view(-1, kvh, dh)[phys] = k[:, 0].to(k_pool.dtype)
    v_pool.view(-1, kvh, dh)[phys] = v[:, 0].to(v_pool.dtype)
    o = decode_attention_paged(q, k_pool, v_pool, block_tables,
                               cache_len + 1, window=window)
    return _wo_proj(p, o)


def decoder_decode_step_paged(params, cfg: ModelConfig, token, cache,
                              cache_len, block_tables, *, page_size: int):
    """One decode step over the paged pool.  token: (B,1) int; cache_len:
    (B,) int; block_tables: (B, P) int32.  Returns (logits (B,1,V),
    cache); the pools in ``cache`` are updated in place."""
    require_ported(cfg)
    h = params["embed"][token.long()]                      # (B,1,D)
    window = _window(cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = h + _attn_decode_paged(
            cfg, lp["attn"], rms_norm(lp["ln1"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], cache_len, block_tables,
            window=window, page=page_size)
        h = h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                    cfg.activation)
    return _logits(params, cfg, h), cache


# -------------------------------------------------------- chunked prefill

def decoder_prefill_chunk(params, cfg: ModelConfig, tokens, past_k, past_v,
                          start: int):
    """One Sarathi-style prefill chunk: run the chunk's tokens against the
    cached prefix and return only the chunk's new KV (the engine scatters
    it into the pool; logits come later from the decode path).

    tokens: (1, C) chunk (C may be padded); past_k/past_v:
    (L, 1, S_past, KV, dh) gathered prefix KV, where S_past may exceed the
    true prefix and ``start`` (the chunk's first position) masks the tail.
    Returns (k_chunk, v_chunk): (L, 1, C, KV, dh)."""
    require_ported(cfg)
    h = params["embed"][tokens.long()]                     # (1, C, D)
    c = h.shape[1]
    dev = h.device
    s_past = past_k.shape[2]
    positions = start + torch.arange(c, device=dev)
    past_pos = torch.arange(s_past, device=dev)
    # invalid prefix rows get position -1e9, which the attention masks
    kv_positions = torch.cat([
        torch.where(past_pos < start, past_pos,
                    torch.full_like(past_pos, -(10 ** 9))), positions])
    window = _window(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _qkv(cfg, lp["attn"],
                       rms_norm(lp["ln1"], h, cfg.norm_eps), positions)
        kf = torch.cat([past_k[i].to(k.dtype), k], dim=1)
        vf = torch.cat([past_v[i].to(v.dtype), v], dim=1)
        o = gqa_attention(q, kf, vf, causal=True, window=window,
                          positions=positions, kv_positions=kv_positions)
        h = h + _wo_proj(lp["attn"], o)
        h = h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                    cfg.activation)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)
