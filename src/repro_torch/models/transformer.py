"""Decoder-only transformer: the dense GQA, MoE, VLM (a dense decoder fed
precomputed patch embeddings before its tokens), Mamba2 SSD (``ssm``) and
hybrid (Mamba2 backbone plus one shared attention block every
``hybrid_attn_every`` layers) families.  Full-sequence forward, decode step
over dense per-row caches, paged decode step and chunked prefill, as plain
functions over a params dict with the reference's stacked ``(L, ...)``
layout and tree keys (``repro.models.transformer``): an MoE model's
leading ``first_k_dense`` dense blocks sit under ``"dense_layers"`` and its
MoE blocks under ``"layers"``, while its KV caches and pools stay one
``(L, ...)`` tensor over all layers.  Layers run as a Python loop over the
stacked axis.

Under a tensor-parallel serving plan (``sharding.context.serving_plan``,
installed by the engine) the paged decode step, the chunked prefill of
the attention families and the atomic prefill (``decoder_forward``) of
the recurrent families run the plan's dataflow instead: per-shard
parameter trees, KV pools and recurrent state, replicated work once on the
plan's first device, sharded work once per shard, and the collectives of
``serving.sharded.ShardingPlan`` (``_sharded_*`` below).

The encoder-decoder family is in ``encdec.py``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding.context import (attn_split_count, constrain_activations,
                                constrain_attn_split, constrain_expert_buf,
                                constrain_heads, constrain_kv_heads,
                                constrain_q_heads, gather_model,
                                serving_plan)
from .attention import decode_attention, decode_attention_paged, \
    gqa_attention
from .config import ModelConfig
from .layers import (ParamSpec, apply_rope, attention_template, linear, mlp,
                     mlp_template, norm_template, rms_norm)
from .moe import (expert_group, expert_mlp, moe_combine, moe_ffn,
                  moe_route, moe_template)
from .ssm import (mamba2_block, mamba2_decode_heads, mamba2_decode_inputs,
                  mamba2_decode_step, mamba2_heads, mamba2_inputs,
                  ssm_state_shape, ssm_template)

__all__ = ["decoder_template", "decoder_forward", "decoder_decode_step",
           "decoder_decode_step_paged", "decoder_prefill_chunk",
           "init_cache_shapes", "paged_cache_shapes", "lm_loss",
           "remat_call"]

# the families whose every layer is an attention block
_ATTN = ("dense", "vlm", "moe")


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``(L, ...)`` parameter subtree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _attn_layers(cfg: ModelConfig, params) -> list[dict]:
    """The attention blocks of an attention family in cache order: an MoE
    model's ``first_k_dense`` dense blocks, then its MoE blocks."""
    fk = cfg.first_k_dense if cfg.family == "moe" else 0
    return ([_layer(params["dense_layers"], i) for i in range(fk)]
            + [_layer(params["layers"], i)
               for i in range(cfg.n_layers - fk)])


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

def _block_template(cfg: ModelConfig, layers: int | None, *,
                    moe: bool = False, d_ff: int = 0):
    """An attention block: MLP of width ``d_ff`` (``cfg.d_ff`` if 0), or
    the MoE FFN."""
    D = cfg.d_model
    t = {"ln1": norm_template(D, layers), "ln2": norm_template(D, layers),
         "attn": attention_template(cfg, layers)}
    if moe:
        t["moe"] = moe_template(cfg, layers)
    else:
        t["mlp"] = mlp_template(D, d_ff or cfg.d_ff, cfg.activation, layers)
    return t


def decoder_template(cfg: ModelConfig):
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    t = {
        "embed": ParamSpec((V, D), torch.bfloat16, ("vocab", "embed")),
        "final_norm": norm_template(D),
    }
    if cfg.family in ("dense", "vlm"):
        t["layers"] = _block_template(cfg, L)
    elif cfg.family == "moe":
        fk = cfg.first_k_dense
        if fk:
            t["dense_layers"] = _block_template(cfg, fk, d_ff=cfg.dense_d_ff)
        t["layers"] = _block_template(cfg, L - fk, moe=True)
    elif cfg.family in ("ssm", "hybrid"):
        t["layers"] = {"ln": norm_template(D, L),
                       "ssm": ssm_template(cfg, L)}
        if cfg.family == "hybrid":
            t["shared_attn"] = _block_template(cfg, None)   # one block
    else:
        raise ValueError(f"decoder_template: bad family {cfg.family}")
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

def _ffn(cfg, lp, x, *, decode: bool):
    """The block's FFN on its normed input: (out, aux loss); the MoE FFN
    where the block has one, which drops no token when ``decode``."""
    if "moe" in lp:
        return moe_ffn(lp["moe"], x, cfg, decode=decode)
    return mlp(lp["mlp"], x, cfg.activation), None


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``remat`` (as the
    reference's ``jax.checkpoint`` of a layer body): the body's saved
    tensors are dropped after the forward and recomputed in the backward.
    Non-reentrant, so the graph and the backward's operations are the same
    either way: the loss and every gradient are bit-identical with and
    without it.  With grad disabled there is nothing to save, and ``fn``
    runs plainly."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _dense_block_seq(cfg, lp, h, positions, window):
    """One attention + FFN block over a sequence; returns (h, k, v, aux)
    (aux None for an MLP block).  The training hooks of
    ``sharding.context`` run where the reference's do."""
    h = constrain_activations(h)
    q, k, v = _qkv(cfg, lp["attn"], rms_norm(lp["ln1"], h, cfg.norm_eps),
                   positions)
    o = gqa_attention(constrain_heads(q), k, v, causal=True, window=window,
                      positions=positions)
    h = h + _wo_proj(lp["attn"], constrain_heads(o))
    f, aux = _ffn(cfg, lp, rms_norm(lp["ln2"], h, cfg.norm_eps),
                  decode=False)
    return h + f, k, v, aux


def _ssm_block_seq(cfg, lp, h, lengths):
    h = constrain_activations(h)
    out, state = mamba2_block(lp["ssm"], rms_norm(lp["ln"], h, cfg.norm_eps),
                              cfg, None, lengths=lengths)
    return h + out, state


def decoder_forward(params, cfg: ModelConfig, tokens, positions=None,
                    frontend_embeds=None, *, collect_cache: bool = False,
                    remat: bool | None = None, lengths=None):
    """Full-sequence forward (training and prefill).  tokens: (B, S) int.
    ``frontend_embeds`` (B, P, D), optional: patch embeddings prepended to
    the tokens' (the VLM's stubbed vision frontend), positions then
    0 .. P + S - 1.  ``remat`` (``cfg.remat`` if None) runs every layer
    body -- the attention (dense, MoE, VLM) block, the Mamba2 block and the
    hybrid's shared attention block -- under ``remat_call``.  ``lengths``
    (B,) int: true row lengths of an end-padded batch, threaded into the
    SSM recurrence (pads leave the state unchanged); the attention is
    causal, so end pads never reach a valid position.  Returns (logits (B,
    S, V), cache or None, aux loss: the MoE layers' summed load-balance
    loss, f32, 0 for the other families).  The cache is {"k", "v"}: (L or
    G, B, S, KV, dh) in the compute dtype, and for the recurrent families
    {"ssm": {"ssd": (L, B, H, P, N) f32, "conv": (L, B, K-1, DI)}}.

    Under a serving plan (the engine's atomic prefill of a recurrent
    family) ``params`` is the plan's per-shard list and the forward runs
    the plan's dataflow (``_sharded_forward``): the cache comes back
    full-head on the first device, the logits as ``_sharded_logits``
    gives them."""
    plan = serving_plan()
    if plan is not None and plan.shards_model:
        if cfg.family not in ("ssm", "hybrid"):
            raise ValueError(f"decoder_forward under a serving plan: the "
                             f"{cfg.family} family prefills by chunks")
        return _sharded_forward(plan, params, cfg, tokens, positions,
                                lengths)
    remat = cfg.remat if remat is None else remat
    h = params["embed"][tokens.long()]
    if frontend_embeds is not None:
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    s = h.shape[1]
    if positions is None:
        positions = torch.arange(s, device=h.device)
    window = _window(cfg)

    def attn_block(lp, hh):
        return _dense_block_seq(cfg, lp, hh, positions, window)

    def ssm_block(lp, hh):
        return _ssm_block_seq(cfg, lp, hh, lengths)

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs, states = [], [], []
    if cfg.family in _ATTN:
        for lp in _attn_layers(cfg, params):
            h, k, v, a = remat_call(remat, attn_block, lp, h)
            if a is not None:
                aux = aux + a
            ks.append(k)
            vs.append(v)
    else:
        for group in _groups(cfg):
            for i in group:
                h, st = remat_call(remat, ssm_block,
                                   _layer(params["layers"], i), h)
                states.append(st)
            if cfg.family == "hybrid":
                h, k, v, _ = remat_call(remat, attn_block,
                                        params["shared_attn"], h)
                ks.append(k)
                vs.append(v)
    logits = _logits(params, cfg, h)
    if not collect_cache:
        return logits, None, aux
    cache = {}
    if ks:
        cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
    if states:
        cache["ssm"] = {name: torch.stack([st[name] for st in states])
                        for name in ("ssd", "conv")}
    return logits, cache, aux


# ------------------------------------------------------- dense-cache decode

def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """{name: (shape, dtype)} of the dense decode cache, nested as the
    reference's: per-row attention KV (L or G, B, max_len, KV, dh) bf16
    (G = ceil(L / every) group layers for the hybrid; a ring of max_len
    slots under a sliding window) and, for the recurrent families,
    {"ssm": {"ssd" f32, "conv" bf16}} per row."""
    out = {}
    if cfg.family in _ATTN + ("hybrid",):
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
    return h + _ffn(cfg, lp, rms_norm(lp["ln2"], h, cfg.norm_eps),
                    decode=True)[0]


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
    h = params["embed"][token.long()]                      # (B,1,D)
    window = _window(cfg)
    if cfg.family in _ATTN:
        for i, lp in enumerate(_attn_layers(cfg, params)):
            h = _dense_block_decode(cfg, lp, h, cache["k"][i], cache["v"][i],
                                    cache_len, window=window)
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


# -------------------------------------------------------------------- loss

def lm_loss(logits, labels, mask=None):
    """Mean next-token cross-entropy.  logits: (B, S, V); labels: (B, S)
    int; mask (B, S), optional: the mean over the masked positions (their
    count at least 1).  f32 ``log_softmax``, as the reference."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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
    out = {}
    if cfg.family in _ATTN + ("hybrid",):
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
    return h + _ffn(cfg, lp, rms_norm(lp["ln2"], h, cfg.norm_eps),
                    decode=True)[0]


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
    plan = serving_plan()
    if plan is not None and plan.shards_model:
        return _sharded_decode_step_paged(plan, params, cfg, token, cache,
                                          cache_len, block_tables,
                                          page=page_size, active=active)
    h = params["embed"][token.long()]                      # (B,1,D)
    window = _window(cfg)
    if cfg.family in _ATTN:
        for i, lp in enumerate(_attn_layers(cfg, params)):
            h = _dense_block_decode_paged(
                cfg, lp, h, cache["k"][i], cache["v"][i], cache_len,
                block_tables, window=window, page=page_size)
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
    The MoE FFN routes the whole padded chunk (its capacity follows C), as
    the reference's does.
    Returns (k_chunk, v_chunk): (L, 1, C, KV, dh)."""
    if cfg.family not in _ATTN:
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
    for i, lp in enumerate(_attn_layers(cfg, params)):
        h = constrain_activations(h)
        q, k, v = _qkv(cfg, lp["attn"],
                       rms_norm(lp["ln1"], h, cfg.norm_eps), positions)
        kf = torch.cat([past_k[i].to(k.dtype), k], dim=1)
        vf = torch.cat([past_v[i].to(v.dtype), v], dim=1)
        o = gqa_attention(q, kf, vf, causal=True, window=window,
                          positions=positions, kv_positions=kv_positions)
        h = h + _wo_proj(lp["attn"], o)
        h = h + _ffn(cfg, lp, rms_norm(lp["ln2"], h, cfg.norm_eps),
                     decode=False)[0]
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


# ------------------------------------------------ tensor-parallel serving
#
# The attention families under ``serving.sharded.ShardingPlan``: ``params``
# is the list of per-shard trees and ``cache`` the list of per-shard pools.
# x, h and every replicated value live on the plan's first device.


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


def _sharded_mlp(plan, cfg, mps, x):
    """An MLP under the plan (``mps``: its per-shard parameter trees):
    column-parallel up/gate, row-parallel down, one psum; replicated on
    the first device when the mlp does not shard."""
    if not plan.mlp_sharded:
        return mlp(mps[0], x, cfg.activation)
    return plan.psum([mlp(mp, x.to(dev), cfg.activation)
                      for mp, dev in zip(mps, plan.devices)])


def _sharded_moe(plan, cfg, mps, x, *, decode: bool):
    """The MoE FFN under the plan (``mps``: its per-shard parameter
    trees); returns (B, S, D) on the first device, the counterpart of the
    reference's ``constrain_expert_buf`` and ``gather_model``.  Router,
    top-K and dispatch run once on the first device; with the experts
    sharded each shard runs its E / tp experts on its slice of the
    capacity buffer, in GEMM calls of the unsharded path's shape
    (``moe.expert_group``), and the slices are all-gathered in shard
    order.  The pick and the K-way sum run replicated, in the unsharded
    order, so the experts add no arithmetic of their own to the plan.
    The shared experts are an MLP (``_sharded_mlp``: one psum where the
    mlp axis shards)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    buf, row, w, _ = moe_route(mps[0], xf, cfg, decode=decode)
    group = expert_group(cfg.n_experts)
    out_buf = gather_model([
        expert_mlp(mp, part, cfg.activation, group)
        for mp, part in zip(mps, constrain_expert_buf(buf))], dim=0)
    out = moe_combine(out_buf, row, w, b * s, cfg.experts_per_token)
    if cfg.n_shared_experts > 0:
        out = out + _sharded_mlp(plan, cfg, [mp["shared"] for mp in mps], xf)
    return out.reshape(b, s, d)


def _sharded_ffn(plan, cfg, lps, x, *, decode: bool):
    """The block's FFN under the plan (``lps``: the per-shard layer
    trees)."""
    if "moe" in lps[0]:
        return _sharded_moe(plan, cfg, [lp["moe"] for lp in lps], x,
                            decode=decode)
    return _sharded_mlp(plan, cfg, [lp["mlp"] for lp in lps], x)


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


def _sharded_ssm_decode(plan, cfg, lps, h, caches, i, active):
    """``_ssm_decode`` of Mamba2 layer i under the plan (``lps``: its
    per-shard trees; ``caches``: the per-shard caches).  Replicated, it is
    ``_ssm_decode`` itself on the first device's state.  Column-parallel,
    B, C, dt and a are computed once and cut to each shard's heads, each
    shard steps its heads' state in place (an inactive row's bits
    unchanged), and the row-parallel out projections are summed (psum)."""
    if not plan.ssm_sharded:
        return _ssm_decode(cfg, lps[0], h, caches[0]["ssm"], i, active)
    x = rms_norm(lps[0]["ln"], h, cfg.norm_eps)
    bvec, cvec, dt, a_decay = mamba2_decode_inputs(lps[0]["ssm"], x, cfg)
    parts = []
    for s, (lp, c, dev) in enumerate(zip(lps, caches, plan.devices)):
        hs = plan.ssm_slice(s)
        st = {"ssd": c["ssm"]["ssd"][i], "conv": c["ssm"]["conv"][i]}
        out, new = mamba2_decode_heads(
            lp["ssm"], x.to(dev), cfg, st, bvec.to(dev), cvec.to(dev),
            dt[:, hs].to(dev), a_decay[:, hs].to(dev),
            lp["ssm"]["d_skip"][hs], None if active is None
            else active.to(dev))
        st["ssd"].copy_(new["ssd"])
        st["conv"].copy_(new["conv"])
        parts.append(out)
    return h + plan.psum(parts)


def _sharded_ssm_seq(plan, cfg, lps, h, lengths):
    """``_ssm_block_seq`` under the plan: (h, the layer's final state
    {"ssd" (B, H, P, N), "conv" (B, K-1, DI)}, full-head on the first
    device).  Column-parallel, each shard scans its heads (the SSD kernel
    takes any H) and the heads' states are all-gathered."""
    if not plan.ssm_sharded:
        return _ssm_block_seq(cfg, lps[0], h, lengths)
    x = rms_norm(lps[0]["ln"], h, cfg.norm_eps)
    bmat, cmat, dt, a_decay = mamba2_inputs(lps[0]["ssm"], x, cfg, lengths)
    parts, ssds, convs = [], [], []
    for s, (lp, dev) in enumerate(zip(lps, plan.devices)):
        hs = plan.ssm_slice(s)
        out, st = mamba2_heads(
            lp["ssm"], x.to(dev), cfg, bmat.to(dev), cmat.to(dev),
            dt[..., hs].to(dev), a_decay[..., hs].to(dev),
            lp["ssm"]["d_skip"][hs],
            lengths=None if lengths is None else lengths.to(dev))
        parts.append(out)
        ssds.append(st["ssd"])
        convs.append(st["conv"])
    return h + plan.psum(parts), {"ssd": plan.all_gather(ssds, 1),
                                  "conv": plan.all_gather(convs, 2)}


def _sharded_attn_seq(plan, cfg, lps, h, positions, window):
    """``_dense_block_seq`` of the hybrid's shared block under the plan:
    the chunk path with no prefix.  Returns (h, k, v), k and v full-head
    on the first device."""
    b = h.shape[0]
    empty = torch.zeros((b, 0, cfg.n_kv_heads, cfg.head_dim), dtype=h.dtype,
                        device=h.device)
    past = plan.split_heads(empty, q_heads=False)
    a, k, v = _sharded_attn_chunk(
        plan, cfg, _shard_cfg(plan, cfg), lps,
        rms_norm(lps[0]["ln1"], h, cfg.norm_eps), past, past, positions,
        positions, window)
    h = h + a
    h = h + _sharded_ffn(plan, cfg, lps,
                         rms_norm(lps[0]["ln2"], h, cfg.norm_eps),
                         decode=False)
    return h, k, v


def _sharded_forward(plan, params, cfg, tokens, positions, lengths):
    """``decoder_forward`` of a recurrent family under the plan, with its
    cache (the atomic prefill): (logits, cache, aux 0)."""
    h = _sharded_embed(plan, params, tokens)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    window = _window(cfg)
    layers = [p["layers"] for p in params]
    ks, vs, ssds, convs = [], [], [], []
    for group in _groups(cfg):
        for i in group:
            h, st = _sharded_ssm_seq(plan, cfg, [_layer(ls, i)
                                                 for ls in layers],
                                     h, lengths)
            ssds.append(st["ssd"])
            convs.append(st["conv"])
        if cfg.family == "hybrid":
            h, k, v = _sharded_attn_seq(plan, cfg,
                                        [p["shared_attn"] for p in params],
                                        h, positions, window)
            ks.append(k)
            vs.append(v)
    cache = {"ssm": {"ssd": torch.stack(ssds), "conv": torch.stack(convs)}}
    if ks:
        cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _sharded_logits(plan, params, cfg, h), cache, aux


def _sharded_decode_step_paged(plan, params, cfg, token, caches, cache_len,
                               block_tables, *, page: int, active=None):
    """``decoder_decode_step_paged`` under the plan."""
    h = _sharded_embed(plan, params, token)
    window = _window(cfg)
    scfg = _shard_cfg(plan, cfg)

    def attn_block(lps, h, i):
        pools = [(c["k"][i], c["v"][i]) for c in caches]
        h = h + _sharded_attn_decode(
            plan, cfg, scfg, lps, rms_norm(lps[0]["ln1"], h, cfg.norm_eps),
            pools, cache_len, block_tables, window=window, page=page)
        return h + _sharded_ffn(plan, cfg, lps,
                                rms_norm(lps[0]["ln2"], h, cfg.norm_eps),
                                decode=True)

    if cfg.family in _ATTN:
        layers = [_attn_layers(cfg, p) for p in params]
        for i in range(cfg.n_layers):
            h = attn_block([ls[i] for ls in layers], h, i)
        return _sharded_logits(plan, params, cfg, h), caches
    layers = [p["layers"] for p in params]
    for gi, group in enumerate(_groups(cfg)):
        for i in group:
            h = _sharded_ssm_decode(plan, cfg,
                                    [_layer(ls, i) for ls in layers], h,
                                    caches, i, active)
        if cfg.family == "hybrid":
            h = attn_block([p["shared_attn"] for p in params], h, gi)
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
    """``decoder_prefill_chunk`` of an attention family under the plan.
    past_k/past_v: per-shard lists of (L, 1, S_past, KV_s, dh).  Returns
    the chunk's full-head (k, v): (L, 1, C, KV, dh) on the first device."""
    h = _sharded_embed(plan, params, tokens)
    positions, kv_positions = _chunk_positions(h.shape[1], past_k[0].shape[2],
                                               start, h.device)
    window = _window(cfg)
    scfg = _shard_cfg(plan, cfg)
    layers = [_attn_layers(cfg, p) for p in params]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lps = [ls[i] for ls in layers]
        a, k, v = _sharded_attn_chunk(
            plan, cfg, scfg, lps, rms_norm(lps[0]["ln1"], h, cfg.norm_eps),
            [pk[i] for pk in past_k], [pv[i] for pv in past_v], positions,
            kv_positions, window)
        h = h + a
        h = h + _sharded_ffn(plan, cfg, lps,
                             rms_norm(lps[0]["ln2"], h, cfg.norm_eps),
                             decode=False)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)
