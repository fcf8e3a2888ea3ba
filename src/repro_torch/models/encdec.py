"""Encoder-decoder backbone (the Seamless-M4T medium language side), the
port of ``repro.models.encdec``.

As in the reference, the audio frontend is stubbed: the encoder takes
precomputed frame embeddings (B, S_enc, D).  Bidirectional encoder stack,
causal decoder with cross-attention, the decoder's self-attention KV cache
and the precomputed cross K/V of every decoder layer.  Layers run as a
Python loop over the stacked ``(L, ...)`` axis.
"""

from __future__ import annotations

import torch

from .attention import encoder_attention, gqa_attention
from .config import ModelConfig
from .layers import (ParamSpec, attention_template, linear, mlp,
                     mlp_template, norm_template, rms_norm)
from .transformer import _attn_decode, _layer, _qkv, _wo_proj, remat_call

__all__ = ["encdec_template", "encode", "encdec_forward",
           "encdec_decode_step", "encdec_cache_shapes"]


def _enc_block_template(cfg, layers):
    return {"ln1": norm_template(cfg.d_model, layers),
            "ln2": norm_template(cfg.d_model, layers),
            "attn": attention_template(cfg, layers),
            "mlp": mlp_template(cfg.d_model, cfg.d_ff, cfg.activation,
                                layers)}


def _dec_block_template(cfg, layers):
    t = _enc_block_template(cfg, layers)
    t["ln_cross"] = norm_template(cfg.d_model, layers)
    t["cross"] = attention_template(cfg, layers)
    return t


def encdec_template(cfg: ModelConfig):
    D, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamSpec((V, D), torch.bfloat16, ("vocab", "embed")),
        "enc_layers": _enc_block_template(cfg, cfg.n_encoder_layers),
        "enc_norm": norm_template(D),
        "dec_layers": _dec_block_template(cfg, cfg.n_layers),
        "final_norm": norm_template(D),
        "lm_head": ParamSpec((D, V), torch.bfloat16, ("embed", "vocab")),
    }


def encode(params, cfg: ModelConfig, frames, remat: bool | None = None):
    """frames: (B, S_enc, D) precomputed embeddings, cast to bf16 ->
    (B, S_enc, D).  RoPE on q and k at arange(S_enc), bidirectional
    attention; each layer under ``remat_call`` when ``remat``
    (``cfg.remat`` if None)."""
    remat = cfg.remat if remat is None else remat
    h = frames.to(torch.bfloat16)
    positions = torch.arange(h.shape[1], device=h.device)

    def body(lp, hh):
        q, k, v = _qkv(cfg, lp["attn"], rms_norm(lp["ln1"], hh, cfg.norm_eps),
                       positions)
        hh = hh + _wo_proj(lp["attn"], encoder_attention(q, k, v))
        return hh + mlp(lp["mlp"], rms_norm(lp["ln2"], hh, cfg.norm_eps),
                        cfg.activation)

    for i in range(cfg.n_encoder_layers):
        h = remat_call(remat, body, _layer(params["enc_layers"], i), h)
    return rms_norm(params["enc_norm"], h, cfg.norm_eps)


def _cross_kv(dec_layers, cfg, enc_out):
    """The cross-attention K and V of every decoder layer, without RoPE:
    (L, B, S_enc, KV, dh) each."""
    b, s, _ = enc_out.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        cp = _layer(dec_layers, i)["cross"]
        ks.append(linear(cp["wk"], enc_out).reshape(b, s, cfg.n_kv_heads,
                                                    cfg.head_dim))
        vs.append(linear(cp["wv"], enc_out).reshape(b, s, cfg.n_kv_heads,
                                                    cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


def _cross_attend(cfg, lp, h, ck, cv):
    """Cross-attention of h's queries (no RoPE) over one layer's cross K/V."""
    b, s, _ = h.shape
    hc = rms_norm(lp["ln_cross"], h, cfg.norm_eps)
    qc = linear(lp["cross"]["wq"], hc).reshape(b, s, cfg.n_heads,
                                               cfg.head_dim)
    return h + _wo_proj(lp["cross"], encoder_attention(qc, ck, cv))


def encdec_forward(params, cfg: ModelConfig, frames, dec_tokens, *,
                   collect_cache: bool = False, remat: bool | None = None):
    """Teacher-forced forward.  frames: (B, S_enc, D); dec_tokens: (B, S)
    int.  ``remat`` (``cfg.remat`` if None) runs each encoder and decoder
    layer under ``remat_call``.  Returns (logits (B, S, V), cache or None,
    aux loss 0); the cache is {"k", "v"}: (L, B, S, KV, dh) and
    {"cross_k", "cross_v"}: (L, B, S_enc, KV, dh)."""
    remat = cfg.remat if remat is None else remat
    enc_out = encode(params, cfg, frames, remat)
    h = params["embed"][dec_tokens.long()]
    positions = torch.arange(h.shape[1], device=h.device)
    ck, cv = _cross_kv(params["dec_layers"], cfg, enc_out)

    def body(lp, hh, ckl, cvl):
        q, k, v = _qkv(cfg, lp["attn"], rms_norm(lp["ln1"], hh, cfg.norm_eps),
                       positions)
        o = gqa_attention(q, k, v, causal=True, positions=positions)
        hh = hh + _wo_proj(lp["attn"], o)
        hh = _cross_attend(cfg, lp, hh, ckl, cvl)
        hh = hh + mlp(lp["mlp"], rms_norm(lp["ln2"], hh, cfg.norm_eps),
                      cfg.activation)
        return hh, k, v

    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, k, v = remat_call(remat, body, _layer(params["dec_layers"], i), h,
                             ck[i], cv[i])
        ks.append(k)
        vs.append(v)
    logits = rms_norm(params["final_norm"], h, cfg.norm_eps) \
        @ params["lm_head"]
    cache = None
    if collect_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "cross_k": ck, "cross_v": cv}
    return logits, cache, torch.zeros((), device=h.device)


def encdec_cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                        enc_len: int):
    """{name: (shape, dtype)}: the decoder's self-attention KV over
    max_len slots and the cross K/V over enc_len frames, all bf16."""
    dh, kv, L = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    self_kv = ((L, batch, max_len, kv, dh), torch.bfloat16)
    cross = ((L, batch, enc_len, kv, dh), torch.bfloat16)
    return {"k": self_kv, "v": self_kv, "cross_k": cross, "cross_v": cross}


def encdec_decode_step(params, cfg: ModelConfig, token, cache, cache_len):
    """One decoder step: self-attention over the dense cache (written in
    place at ``cache_len``, unlike the functional reference), then a
    one-query cross-attention over the precomputed cross K/V.
    token: (B,1) int; cache_len: (B,) int.  Returns (logits (B,1,V),
    cache)."""
    h = params["embed"][token.long()]                      # (B,1,D)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = h + _attn_decode(cfg, lp["attn"],
                             rms_norm(lp["ln1"], h, cfg.norm_eps),
                             cache["k"][i], cache["v"][i], cache_len,
                             window=0)
        h = _cross_attend(cfg, lp, h, cache["cross_k"][i],
                          cache["cross_v"][i])
        h = h + mlp(lp["mlp"], rms_norm(lp["ln2"], h, cfg.norm_eps),
                    cfg.activation)
    logits = rms_norm(params["final_norm"], h, cfg.norm_eps) \
        @ params["lm_head"]
    return logits, cache
