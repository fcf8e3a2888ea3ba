"""Decoder-only transformer: the dense GQA, Mamba2 SSD (``ssm``) and hybrid
(Mamba2 backbone plus one shared attention block every
``hybrid_attn_every`` layers) families.  Full-sequence forward, decode step
over dense per-row caches, paged decode step and chunked prefill, as plain
functions over a params dict
with the reference's stacked ``(L, ...)`` layout and tree keys
(``repro.models.transformer``).  Layers run as a Python loop over the
stacked axis.

Under a tensor-parallel serving plan (``sharding.context.serving_plan``,
installed by the engine) the dense family's paged decode step and chunked
prefill run the plan's dataflow instead: per-shard parameter trees and KV
pools, replicated work once on the plan's first device, sharded work once
per shard, and the collectives of ``serving.sharded.ShardingPlan``
(``_sharded_*`` below).

The encoder-decoder family is in ``encdec.py``.  The MoE and VLM
families are not ported yet: building them raises
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from ..sharding.context import (attn_split_count, constrain_attn_split,
                                constrain_kv_heads, constrain_q_heads,
                                gather_model, serving_plan)
from .attention import decode_attention, decode_attention_paged, \
    gqa_attention
from .config import ModelConfig
from .layers import (ParamSpec, apply_rope, attention_template, linear, mlp,
                     mlp_template, norm_template, rms_norm)
from .ssm import (mamba2_block, mamba2_decode_step, ssm_state_shape,
                  ssm_template)

__all__ = ["decoder_template", "decoder_forward", "decoder_decode_step",
           "decoder_decode_step_paged", "decoder_prefill_chunk",
           "init_cache_shapes", "paged_cache_shapes", "require_ported"]

_PORTED = ("dense", "ssm", "hybrid", "encdec")
_NOT_PORTED = {
    "moe": "ROADMAP Queue A 6 (MoE and VLM families)",
    "vlm": "ROADMAP Queue A 6 (MoE and VLM families)",
}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet ({_NOT_PORTED.get(cfg.family, 'ROADMAP')})")


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``(L, ...)`` parameter subtree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attention_kind == "sliding_window" else 0


def _groups(cfg: ModelConfig) -> list[range]:
    """The Mamba2 layers of each group: for the hybrid, the shared
    attention block runs after each group (G = ceil(L / every) groups);
    the SSM family is one group with no attention."""
    every, L = cfg.hybrid_attn_every, cfg.n_layers
    if cfg.family != "hybrid":
        return [range(L)]
    return [range(s, min(s + every, L)) for s in range(0, L, every)]


# ------------------------------------------------------------------ template

def _dense_template(cfg: ModelConfig, layers: int | None):
    D = cfg.d_model
    return {"ln1": norm_template(D, layers), "ln2": norm_template(D, layers),
            "attn": attention_template(cfg, layers),
            "mlp": mlp_template(D, cfg.d_ff, cfg.activation, layers)}


def decoder_template(cfg: ModelConfig):
    require_ported(cfg)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    t = {
        "embed": ParamSpec((V, D), torch.bfloat16, ("vocab", "embed")),
        "final_norm": norm_template(D),
    }
    if cfg.family == "dense":
        t["layers"] = _dense_template(cfg, L)
    else:
        t["layers"] = {"ln": norm_template(D, L),
                       "ssm": ssm_template(cfg, L)}
        if cfg.family == "hybrid":
            t["shared_attn"] = _dense_template(cfg, None)   # one block
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((D, V), torch.bfloat16, ("embed", "vocab"))
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


def _head(params, cfg):
    """The (D, V) output projection (the embedding's transpose if tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg, h):
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return h @ _head(params, cfg)


# ------------------------------------------------------- sequence forward

def _dense_block_seq(cfg, lp, h, positions, window):
    """One attention + MLP block over a sequence; returns (h, k, v)."""
    q, k, v = _qkv(cfg, lp["attn"], rms_norm(lp["ln1"], h, cfg.norm_eps),
                   positions)
    o = gqa_attention(q, k, v, causal=True, window=window,
                      positions=positions)
    h = h + _wo_proj(lp["attn"], o)
    h = h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                cfg.activation)
    return h, k, v


def _ssm_block_seq(cfg, lp, h, lengths):
    out, state = mamba2_block(lp["ssm"], rms_norm(lp["ln"], h, cfg.norm_eps),
                              cfg, None, lengths=lengths)
    return h + out, state


def decoder_forward(params, cfg: ModelConfig, tokens, positions=None, *,
                    collect_cache: bool = False, lengths=None):
    """Full-sequence forward (prefill).  tokens: (B, S) int.
    ``lengths`` (B,) int: true row lengths of an end-padded batch, threaded
    into the SSM recurrence (pads leave the state unchanged); the
    attention is causal, so end pads never reach a valid position.
    Returns (logits (B, S, V), cache or None, aux loss 0).  The cache is
    {"k", "v"}: (L or G, B, S, KV, dh) in the compute dtype, and for the
    recurrent families {"ssm": {"ssd": (L, B, H, P, N) f32,
    "conv": (L, B, K-1, DI)}}."""
    require_ported(cfg)
    h = params["embed"][tokens.long()]
    s = h.shape[1]
    if positions is None:
        positions = torch.arange(s, device=h.device)
    window = _window(cfg)
    ks, vs, states = [], [], []
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            h, k, v = _dense_block_seq(cfg, _layer(params["layers"], i), h,
                                       positions, window)
            ks.append(k)
            vs.append(v)
    else:
        for group in _groups(cfg):
            for i in group:
                h, st = _ssm_block_seq(cfg, _layer(params["layers"], i), h,
                                       lengths)
                states.append(st)
            if cfg.family == "hybrid":
                h, k, v = _dense_block_seq(cfg, params["shared_attn"], h,
                                           positions, window)
                ks.append(k)
                vs.append(v)
    logits = _logits(params, cfg, h)
    if not collect_cache:
        return logits, None, torch.zeros((), device=h.device)
    cache = {}
    if ks:
        cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
    if states:
        cache["ssm"] = {name: torch.stack([st[name] for st in states])
                        for name in ("ssd", "conv")}
    return logits, cache, torch.zeros((), device=h.device)


# ------------------------------------------------------- dense-cache decode

def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """{name: (shape, dtype)} of the dense decode cache, nested as the
    reference's: per-row attention KV (L or G, B, max_len, KV, dh) bf16
    (G = ceil(L / every) group layers for the hybrid; a ring of max_len
    slots under a sliding window) and, for the recurrent families,
    {"ssm": {"ssd" f32, "conv" bf16}} per row."""
    require_ported(cfg)
    out = {}
    if cfg.family in ("dense", "hybrid"):
        n_kv = len(_groups(cfg)) if cfg.family == "hybrid" else cfg.n_layers
        shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = (shape, torch.bfloat16)
        out["v"] = (shape, torch.bfloat16)
    if cfg.family in ("ssm", "hybrid"):
        ss = ssm_state_shape(cfg, batch)
        out["ssm"] = {
            "ssd": ((cfg.n_layers,) + ss["ssd"], torch.float32),
            "conv": ((cfg.n_layers,) + ss["conv"], torch.bfloat16),
        }
    return out


def _update_cache(cache_l, new, pos):
    """cache_l: (B, S, KV, dh); new: (B, 1, KV, dh); pos: (B,) write
    index, clamped to S - 1 as ``lax.dynamic_update_slice`` clamps it.
    Writes in place."""
    b, s_max = cache_l.shape[:2]
    rows = torch.arange(b, device=cache_l.device)
    cache_l[rows, torch.clamp(pos.long(), max=s_max - 1)] = \
        new[:, 0].to(cache_l.dtype)


def _attn_decode(cfg, p, h, k_cache, v_cache, cache_len, *, window: int):
    """h: (B,1,D); k_cache/v_cache: (B, S_max, KV, dh) of one layer.
    Writes this step's KV at ``cache_len`` (at ``cache_len % S_max`` in a
    ring, ``window > 0``), in place, then attends with ``cache_len + 1``."""
    q, k, v = _qkv(cfg, p, h, cache_len[:, None])
    write = cache_len % k_cache.shape[1] if window > 0 else cache_len
    _update_cache(k_cache, k, write)
    _update_cache(v_cache, v, write)
    o = decode_attention(q, k_cache, v_cache, cache_len + 1, window=window)
    return _wo_proj(p, o)


def _dense_block_decode(cfg, lp, h, k_cache, v_cache, cache_len, *,
                        window: int):
    h = h + _attn_decode(cfg, lp["attn"],
                         rms_norm(lp["ln1"], h, cfg.norm_eps), k_cache,
                         v_cache, cache_len, window=window)
    return h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                   cfg.activation)


def decoder_decode_step(params, cfg: ModelConfig, token, cache, cache_len):
    """One decode step over the dense per-row cache.  token: (B,1) int;
    cache_len: (B,) int, tokens already in the cache.  Returns (logits
    (B,1,V), cache).

    Unlike the reference, which is functional and returns a new cache,
    the KV and recurrent state in ``cache`` are updated in place (as the
    paged step updates its pools): the returned cache is the same dict,
    and the caller's cache is no longer the pre-step cache.  The
    recurrent families advance every row's state whatever ``cache_len``
    is, as the reference does."""
    require_ported(cfg)
    h = params["embed"][token.long()]                      # (B,1,D)
    window = _window(cfg)
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            h = _dense_block_decode(
                cfg, _layer(params["layers"], i), h, cache["k"][i],
                cache["v"][i], cache_len, window=window)
        return _logits(params, cfg, h), cache
    for gi, group in enumerate(_groups(cfg)):
        for i in group:
            h = _ssm_decode(cfg, _layer(params["layers"], i), h,
                            cache["ssm"], i, None)
        if cfg.family == "hybrid":
            h = _dense_block_decode(
                cfg, params["shared_attn"], h, cache["k"][gi],
                cache["v"][gi], cache_len, window=window)
    return _logits(params, cfg, h), cache


# ---------------------------------------------------------- paged serving

def paged_cache_shapes(cfg: ModelConfig, n_pages: int, page_size: int,
                       n_slots: int, conv_dtype: torch.dtype = torch.bfloat16):
    """{name: (shape, dtype)} of the paged decode cache, nested as the
    reference's: attention KV in one (L, n_pages, page, KV, dh) bf16 pool
    for K and one for V, shared by the batch through block tables (page
    0 is the engine's scratch page), with G = ceil(L / every) group
    layers for the hybrid; recurrent state, which has nothing to page,
    per decode slot under {"ssm": {"ssd", "conv"}}.  The conv tail is
    held in the compute dtype ``conv_dtype`` (bf16 on the card, as the
    reference declares it), the dtype the decode step returns it in: a
    bf16 tail under f32 weights would round the state every step."""
    require_ported(cfg)
    out = {}
    if cfg.family in ("dense", "hybrid"):
        n_kv = len(_groups(cfg)) if cfg.family == "hybrid" else cfg.n_layers
        shape = (n_kv, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = (shape, torch.bfloat16)
        out["v"] = (shape, torch.bfloat16)
    if cfg.family in ("ssm", "hybrid"):
        ss = ssm_state_shape(cfg, n_slots)
        out["ssm"] = {
            "ssd": ((cfg.n_layers,) + ss["ssd"], torch.float32),
            "conv": ((cfg.n_layers,) + ss["conv"], conv_dtype),
        }
    return out


def _attn_decode_paged(cfg, p, x, k_pool, v_pool, cache_len, block_tables,
                       *, window: int, page: int):
    """x: (B,1,D); pools (n_pages, page, KV, dh) of one layer.  Writes this
    step's KV at each row's logical position through its block table
    (inactive rows point at the scratch page), then attends with
    ``cache_len + 1``."""
    q, k, v = _qkv(cfg, p, x, cache_len[:, None])
    _write_step_kv(k_pool, v_pool, _pool_index(cache_len, block_tables, page),
                   k, v)
    o = decode_attention_paged(q, k_pool, v_pool, block_tables,
                               cache_len + 1, window=window)
    return _wo_proj(p, o)


def _pool_index(cache_len, block_tables, page: int):
    """(B,) flat pool index of each row's write position cache_len."""
    logical = cache_len.long()
    page_idx = torch.clamp(logical // page, max=block_tables.shape[1] - 1)
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    return block_tables[rows, page_idx].long() * page + logical % page


def _write_step_kv(k_pool, v_pool, phys, k, v) -> None:
    """Write one step's k, v (B, 1, KV, dh) at flat pool indices ``phys``,
    in place: the step's K/V land straight in the shared pool instead of a
    functional update that would copy the layer's whole pool."""
    kvh, dh = k_pool.shape[2:]
    k_pool.view(-1, kvh, dh)[phys] = k[:, 0].to(k_pool.dtype)
    v_pool.view(-1, kvh, dh)[phys] = v[:, 0].to(v_pool.dtype)


def _dense_block_decode_paged(cfg, lp, h, k_pool, v_pool, cache_len,
                              block_tables, *, window: int, page: int):
    h = h + _attn_decode_paged(
        cfg, lp["attn"], rms_norm(lp["ln1"], h, cfg.norm_eps), k_pool,
        v_pool, cache_len, block_tables, window=window, page=page)
    return h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                   cfg.activation)


def _ssm_decode(cfg, lp, h, ssm_cache, i, active):
    """One Mamba2 layer's decode; writes layer i's new state into the
    per-slot cache in place."""
    st = {"ssd": ssm_cache["ssd"][i], "conv": ssm_cache["conv"][i]}
    out, new = mamba2_decode_step(lp["ssm"],
                                  rms_norm(lp["ln"], h, cfg.norm_eps), cfg,
                                  st, active=active)
    st["ssd"].copy_(new["ssd"])
    st["conv"].copy_(new["conv"])
    return h + out


def decoder_decode_step_paged(params, cfg: ModelConfig, token, cache,
                              cache_len, block_tables, *, page_size: int,
                              active=None):
    """One decode step over the paged pool.  token: (B,1) int; cache_len:
    (B,) int; block_tables: (B, P) int32.  Returns (logits (B,1,V),
    cache); the pools and the per-slot recurrent state in ``cache`` are
    updated in place.  The SSM family ignores cache_len and the tables,
    and advances every row's state, as the reference does.

    ``active`` (B,) bool, optional (recurrent families): rows where it is
    False keep their recurrent state bit-unchanged, which is what the
    reference's fused step gets by selecting the old state back."""
    require_ported(cfg)
    plan = serving_plan()
    if plan is not None and plan.shards_model:
        return _sharded_decode_step_paged(plan, params, cfg, token, cache,
                                          cache_len, block_tables,
                                          page=page_size)
    h = params["embed"][token.long()]                      # (B,1,D)
    window = _window(cfg)
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            h = _dense_block_decode_paged(
                cfg, _layer(params["layers"], i), h, cache["k"][i],
                cache["v"][i], cache_len, block_tables, window=window,
                page=page_size)
        return _logits(params, cfg, h), cache
    for gi, group in enumerate(_groups(cfg)):
        for i in group:
            h = _ssm_decode(cfg, _layer(params["layers"], i), h,
                            cache["ssm"], i, active)
        if cfg.family == "hybrid":
            h = _dense_block_decode_paged(
                cfg, params["shared_attn"], h, cache["k"][gi],
                cache["v"][gi], cache_len, block_tables, window=window,
                page=page_size)
    return _logits(params, cfg, h), cache


# -------------------------------------------------------- chunked prefill

def _chunk_positions(c: int, s_past: int, start: int, dev):
    """Positions of a chunk of c tokens at ``start`` and of its keys: the
    gathered prefix (rows at or past ``start`` get -1e9, which the
    attention masks) followed by the chunk."""
    positions = start + torch.arange(c, device=dev)
    past_pos = torch.arange(s_past, device=dev)
    kv_positions = torch.cat([
        torch.where(past_pos < start, past_pos,
                    torch.full_like(past_pos, -(10 ** 9))), positions])
    return positions, kv_positions


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
    if cfg.family != "dense":
        raise ValueError(f"chunked prefill unsupported for {cfg.family}")
    plan = serving_plan()
    if plan is not None and plan.shards_model:
        return _sharded_prefill_chunk(plan, params, cfg, tokens, past_k,
                                      past_v, start)
    h = params["embed"][tokens.long()]                     # (1, C, D)
    positions, kv_positions = _chunk_positions(h.shape[1], past_k.shape[2],
                                               start, h.device)
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


# ------------------------------------------------ tensor-parallel serving
#
# The dense family under ``serving.sharded.ShardingPlan``: ``params`` is the
# list of per-shard trees and ``cache`` the list of per-shard pools.  x, h
# and every replicated value live on the plan's first device.


def _sharded_embed(plan, params, tokens):
    """Token embeddings, (B, S, D) on the first device.  Vocab-sharded: each
    shard looks up the ids it holds and writes 0 for the others, and the
    psum adds one nonzero term per token (exact)."""
    if not plan.vocab_sharded:
        return params[0]["embed"][tokens.long()]
    parts = []
    for s, (p, dev) in enumerate(zip(params, plan.devices)):
        emb = p["embed"]
        n = emb.shape[0]
        local = tokens.long().to(dev) - s * n
        inside = (local >= 0) & (local < n)
        e = emb[local.clamp(0, n - 1)]
        parts.append(torch.where(inside[..., None], e, torch.zeros_like(e)))
    return plan.psum(parts)


def _sharded_logits(plan, params, cfg, h):
    """Final norm and logits: (B, S, V) on the first device, or, with the
    vocab sharded, the list of per-shard (B, S, V / tp) column slices (the
    engine samples them partitioned)."""
    h = rms_norm(params[0]["final_norm"], h, cfg.norm_eps)
    if not plan.vocab_sharded:
        return h @ _head(params[0], cfg)
    return [h.to(dev) @ _head(p, cfg) for p, dev in zip(params,
                                                          plan.devices)]


def _sharded_mlp(plan, cfg, lps, x):
    """Column-parallel up/gate, row-parallel down, one psum; replicated on
    the first device when the mlp does not shard."""
    if not plan.mlp_sharded:
        return mlp(lps[0]["mlp"], x, cfg.activation)
    return plan.psum([mlp(lp["mlp"], x.to(dev), cfg.activation)
                      for lp, dev in zip(lps, plan.devices)])


def _shard_cfg(plan, cfg):
    """The config a column-parallel shard projects with (its heads); None
    when the heads do not shard."""
    if not plan.heads_sharded:
        return None
    return cfg.with_overrides(n_heads=cfg.n_heads // plan.tp,
                              n_kv_heads=cfg.n_kv_heads // plan.tp)


def _sharded_attn_decode(plan, cfg, scfg, lps, x, pools, cache_len,
                         block_tables, *, window: int, page: int):
    """One layer's decode attention under the plan; returns (B, 1, D) on
    the first device.  ``pools``: the per-shard (k_pool, v_pool) of the
    layer; ``scfg``: a column-parallel shard's config."""
    phys = _pool_index(cache_len, block_tables, page)
    if plan.heads_sharded:
        # efficient, heads dividing: column-parallel q/k/v, each shard
        # writes and attends over its own kv heads, row-parallel wo + psum
        parts = []
        for lp, (kp, vp), dev in zip(lps, pools, plan.devices):
            cl = cache_len.to(dev)
            q, k, v = _qkv(scfg, lp["attn"], x.to(dev), cl[:, None])
            _write_step_kv(kp, vp, phys.to(dev), k, v)
            o = decode_attention_paged(q, kp, vp, block_tables.to(dev),
                                       cl + 1, window=window)
            parts.append(_wo_proj(lp["attn"], o))
        return plan.psum(parts)
    # replicated projections: exact mode, or heads that do not divide
    q, k, v = _qkv(cfg, lps[0]["attn"], x, cache_len[:, None])
    ks, vs = constrain_kv_heads(k), constrain_kv_heads(v)
    for s in plan.pool_owners:
        kp, vp = pools[s]
        _write_step_kv(kp, vp, phys.to(kp.device), ks[s], vs[s])
    n_splits = attn_split_count()
    if n_splits > 1:
        # efficient, heads not dividing: the LSE split, stripe s on shard s
        o = decode_attention_paged(q, *pools[0], block_tables, cache_len + 1,
                                   window=window, n_splits=n_splits,
                                   stripe_pools=constrain_attn_split(pools))
    elif plan.pool_sharded:
        # exact: each shard attends over its kv heads, outputs gathered
        o = gather_model([
            decode_attention_paged(qs, kp, vp, block_tables.to(qs.device),
                                   (cache_len + 1).to(qs.device),
                                   window=window)
            for qs, (kp, vp) in zip(constrain_q_heads(q), pools)], dim=2)
    else:
        o = decode_attention_paged(q, *pools[0], block_tables, cache_len + 1,
                                   window=window)
    return _wo_proj(lps[0]["attn"], o)


def _sharded_decode_step_paged(plan, params, cfg, token, caches, cache_len,
                               block_tables, *, page: int):
    """``decoder_decode_step_paged`` of the dense family under the plan."""
    h = _sharded_embed(plan, params, token)
    window = _window(cfg)
    scfg = _shard_cfg(plan, cfg)
    for i in range(cfg.n_layers):
        lps = [_layer(p["layers"], i) for p in params]
        pools = [(c["k"][i], c["v"][i]) for c in caches]
        h = h + _sharded_attn_decode(
            plan, cfg, scfg, lps, rms_norm(lps[0]["ln1"], h, cfg.norm_eps),
            pools, cache_len, block_tables, window=window, page=page)
        h = h + _sharded_mlp(plan, cfg, lps,
                             rms_norm(lps[0]["ln2"], h, cfg.norm_eps))
    return _sharded_logits(plan, params, cfg, h), caches


def _sharded_attn_chunk(plan, cfg, scfg, lps, x, past_k, past_v, positions,
                        kv_positions, window: int):
    """One layer's chunk attention under the plan.  past_k/past_v: the
    per-shard (1, S_past, KV_s, dh) prefix.  Returns (out (1, C, D), k, v
    (1, C, KV, dh)), all on the first device."""
    if plan.heads_sharded:
        parts, ks, vs = [], [], []
        for lp, pk, pv, dev in zip(lps, past_k, past_v, plan.devices):
            pos = positions.to(dev)
            q, k, v = _qkv(scfg, lp["attn"], x.to(dev), pos)
            o = gqa_attention(q, torch.cat([pk.to(k.dtype), k], dim=1),
                              torch.cat([pv.to(v.dtype), v], dim=1),
                              causal=True, window=window, positions=pos,
                              kv_positions=kv_positions.to(dev))
            parts.append(_wo_proj(lp["attn"], o))
            ks.append(k)
            vs.append(v)
        return (plan.psum(parts), plan.all_gather(ks, 2),
                plan.all_gather(vs, 2))
    q, k, v = _qkv(cfg, lps[0]["attn"], x, positions)
    if plan.pool_sharded:
        outs = []
        for qs, ks, vs, pk, pv in zip(constrain_q_heads(q),
                                      constrain_kv_heads(k),
                                      constrain_kv_heads(v), past_k, past_v):
            dev = qs.device
            outs.append(gqa_attention(
                qs, torch.cat([pk.to(ks.dtype), ks], dim=1),
                torch.cat([pv.to(vs.dtype), vs], dim=1), causal=True,
                window=window, positions=positions.to(dev),
                kv_positions=kv_positions.to(dev)))
        o = gather_model(outs, dim=2)
    else:
        o = gqa_attention(q, torch.cat([past_k[0].to(k.dtype), k], dim=1),
                          torch.cat([past_v[0].to(v.dtype), v], dim=1),
                          causal=True, window=window, positions=positions,
                          kv_positions=kv_positions)
    return _wo_proj(lps[0]["attn"], o), k, v


def _sharded_prefill_chunk(plan, params, cfg, tokens, past_k, past_v,
                           start: int):
    """``decoder_prefill_chunk`` of the dense family under the plan.
    past_k/past_v: per-shard lists of (L, 1, S_past, KV_s, dh).  Returns
    the chunk's full-head (k, v): (L, 1, C, KV, dh) on the first device."""
    h = _sharded_embed(plan, params, tokens)
    positions, kv_positions = _chunk_positions(h.shape[1], past_k[0].shape[2],
                                               start, h.device)
    window = _window(cfg)
    scfg = _shard_cfg(plan, cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lps = [_layer(p["layers"], i) for p in params]
        a, k, v = _sharded_attn_chunk(
            plan, cfg, scfg, lps, rms_norm(lps[0]["ln1"], h, cfg.norm_eps),
            [pk[i] for pk in past_k], [pv[i] for pv in past_v], positions,
            kv_positions, window)
        h = h + a
        h = h + _sharded_mlp(plan, cfg, lps,
                             rms_norm(lps[0]["ln2"], h, cfg.norm_eps))
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)
