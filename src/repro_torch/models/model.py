"""Model facade: one object per architecture with a uniform API
(the port of ``repro.models.model``; the decoder-only dense, MoE, VLM,
SSM and hybrid families and the encoder-decoder).

    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, cache = model.decode_step(params, tok, cache, cache_len)
    k, v = model.prefill_chunk(params, tokens, past_k, past_v, start)
    logits, cache = model.decode_step_paged(params, tok, cache, cache_len,
                                            tables, page_size=16)
    loss, aux = model.loss_fn(params, {"tokens": t, "labels": t})  # training
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .config import ModelConfig
from .encdec import (encdec_cache_shapes, encdec_decode_step, encdec_forward,
                     encdec_template)
from .layers import init_from_template, specs_from_template
from .transformer import (decoder_decode_step, decoder_decode_step_paged,
                          decoder_forward, decoder_prefill_chunk,
                          decoder_template, init_cache_shapes, lm_loss,
                          paged_cache_shapes)

__all__ = ["Model", "build_model"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params

    def template(self):
        if self.cfg.family == "encdec":
            return encdec_template(self.cfg)
        return decoder_template(self.cfg)

    def init(self, generator: torch.Generator):
        """Random weights on the generator's device."""
        return init_from_template(self.template(), generator)

    def param_specs(self):
        """The logical-axis tree of the parameters."""
        return specs_from_template(self.template())

    # ------------------------------------------------------------ forward

    def forward(self, params, batch, *, collect_cache: bool = False,
                remat: bool | None = None):
        """Batches are dicts: {"tokens": (B, S)} for the decoder
        families, plus "patches": (B, P, D) for the VLM (optional: its
        stubbed frontend's embeddings, prepended) and "frames": (B, S_enc,
        D) for the encoder-decoder.  ``remat`` (``cfg.remat`` if None)
        checkpoints each layer.  Returns (logits, cache or None, aux
        loss)."""
        if self.cfg.family == "encdec":
            return encdec_forward(params, self.cfg, batch["frames"],
                                  batch["tokens"],
                                  collect_cache=collect_cache, remat=remat)
        fe = batch.get("patches") if self.cfg.family == "vlm" else None
        return decoder_forward(params, self.cfg, batch["tokens"],
                               frontend_embeds=fe,
                               collect_cache=collect_cache, remat=remat,
                               lengths=batch.get("lengths"))

    def loss_fn(self, params, batch, remat: bool | None = None):
        """Scalar LM loss plus the router aux loss: (loss, {"lm_loss",
        "aux_loss"}).  ``batch`` adds "labels" (B, S) and, optionally,
        "loss_mask" over the S - 1 shifted positions, as the reference
        takes it; the VLM's patch positions are dropped from the logits,
        then the next-token shift."""
        logits, _, aux = self.forward(params, batch, remat=remat)
        labels = batch["labels"]
        if self.cfg.family == "vlm" and "patches" in batch:
            logits = logits[:, batch["patches"].shape[1]:]
        loss = lm_loss(logits[:, :-1], labels[:, 1:], batch.get("loss_mask"))
        return loss + aux, {"lm_loss": loss, "aux_loss": aux}

    def prefill(self, params, batch):
        """Returns (last-position logits (B, V), cache dict).

        ``batch`` may carry ``"lengths"`` (B,) true row lengths of an
        end-padded token buffer: the recurrent families mask the scan, so
        the returned state equals an unpadded prefill's (the engine pads
        to pow2 buckets).  The last-position logits are then a pad
        position's, which the engine never reads.  Under a serving plan
        with the vocab sharded they are the list of per-shard (B, V / tp)
        column slices."""
        logits, cache, _ = self.forward(params, batch, collect_cache=True,
                                        remat=False)
        if isinstance(logits, list):
            return [part[:, -1, :] for part in logits], cache
        return logits[:, -1, :], cache

    # ------------------------------------------------ dense-cache decode

    def decode_step(self, params, token, cache, cache_len):
        """token: (B,1); cache_len: (B,).  Returns ((B,V) logits, cache),
        the cache updated in place (the reference returns a new one)."""
        if self.cfg.family == "encdec":
            logits, cache = encdec_decode_step(params, self.cfg, token,
                                               cache, cache_len)
        else:
            logits, cache = decoder_decode_step(params, self.cfg, token,
                                                cache, cache_len)
        return logits[:, -1, :], cache

    def cache_shapes(self, batch: int, max_len: int, enc_len: int = 0):
        """{name: (shape, dtype)} of the dense decode cache."""
        if self.cfg.family == "encdec":
            return encdec_cache_shapes(self.cfg, batch, max_len, enc_len)
        return init_cache_shapes(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0,
                   device: str | torch.device = "cuda"):
        return _zeros(self.cache_shapes(batch, max_len, enc_len), device)

    # ----------------------------------------------------- paged serving

    @property
    def supports_paged(self) -> bool:
        return self.cfg.family != "encdec"

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.cfg.family in ("dense", "vlm", "moe")

    def paged_cache_shapes(self, n_pages: int, page_size: int,
                           n_slots: int,
                           conv_dtype: torch.dtype = torch.bfloat16):
        return paged_cache_shapes(self.cfg, n_pages, page_size, n_slots,
                                  conv_dtype)

    def init_paged_cache(self, n_pages: int, page_size: int, n_slots: int,
                         device: str | torch.device = "cuda",
                         conv_dtype: torch.dtype = torch.bfloat16):
        return _zeros(self.paged_cache_shapes(n_pages, page_size, n_slots,
                                              conv_dtype), device)

    def decode_step_paged(self, params, token, cache, cache_len,
                          block_tables, *, page_size: int, active=None):
        """token: (B,1); cache_len: (B,); block_tables: (B, P) int32.
        Returns ((B, V) logits, cache), the pools and recurrent state
        updated in place.  ``active`` (B,) bool, optional, freezes the
        recurrent state of the rows where it is False.  Under a serving
        plan with the vocab sharded the logits are the list of per-shard
        (B, V / tp) column slices."""
        logits, cache = decoder_decode_step_paged(
            params, self.cfg, token, cache, cache_len, block_tables,
            page_size=page_size, active=active)
        if isinstance(logits, list):
            return [part[:, -1, :] for part in logits], cache
        return logits[:, -1, :], cache

    def prefill_chunk(self, params, tokens, past_k, past_v, start: int):
        """One prefill chunk against the cached prefix; returns the
        chunk's (k, v): (L, 1, C, KV, dh) for the engine to scatter."""
        return decoder_prefill_chunk(params, self.cfg, tokens, past_k,
                                     past_v, start)


def _zeros(node, device):
    """Zero tensors for a nested {name: (shape, dtype)} tree."""
    if isinstance(node, dict):
        return {k: _zeros(v, device) for k, v in node.items()}
    shape, dtype = node
    return torch.zeros(shape, dtype=dtype, device=device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
