"""Model facade: one object per architecture with a uniform API
(the port of ``repro.models.model``; decoder-only dense, SSM and hybrid
families).

    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": tokens})
    k, v = model.prefill_chunk(params, tokens, past_k, past_v, start)
    logits, cache = model.decode_step_paged(params, tok, cache, cache_len,
                                            tables, page_size=16)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .config import ModelConfig
from .layers import init_from_template
from .transformer import (decoder_decode_step_paged, decoder_forward,
                          decoder_prefill_chunk, decoder_template,
                          paged_cache_shapes, require_ported)

__all__ = ["Model", "build_model"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        require_ported(self.cfg)

    # ------------------------------------------------------------- params

    def template(self):
        return decoder_template(self.cfg)

    def init(self, generator: torch.Generator):
        """Random weights on the generator's device."""
        return init_from_template(self.template(), generator)

    # ------------------------------------------------------------ forward

    def forward(self, params, batch, *, collect_cache: bool = False):
        return decoder_forward(params, self.cfg, batch["tokens"],
                               collect_cache=collect_cache,
                               lengths=batch.get("lengths"))

    def prefill(self, params, batch):
        """Returns (last-position logits (B, V), cache dict).

        ``batch`` may carry ``"lengths"`` (B,) true row lengths of an
        end-padded token buffer: the recurrent families mask the scan, so
        the returned state equals an unpadded prefill's (the engine pads
        to pow2 buckets).  The last-position logits are then a pad
        position's, which the engine never reads."""
        logits, cache, _ = self.forward(params, batch, collect_cache=True)
        return logits[:, -1, :], cache

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
        def zeros(node):
            if isinstance(node, dict):
                return {k: zeros(v) for k, v in node.items()}
            shape, dtype = node
            return torch.zeros(shape, dtype=dtype, device=device)
        return zeros(self.paged_cache_shapes(n_pages, page_size, n_slots,
                                             conv_dtype))

    def decode_step_paged(self, params, token, cache, cache_len,
                          block_tables, *, page_size: int, active=None):
        """token: (B,1); cache_len: (B,); block_tables: (B, P) int32.
        Returns ((B, V) logits, cache), the pools and recurrent state
        updated in place.  ``active`` (B,) bool, optional, freezes the
        recurrent state of the rows where it is False."""
        logits, cache = decoder_decode_step_paged(
            params, self.cfg, token, cache, cache_len, block_tables,
            page_size=page_size, active=active)
        return logits[:, -1, :], cache

    def prefill_chunk(self, params, tokens, past_k, past_v, start: int):
        """One prefill chunk against the cached prefix; returns the
        chunk's (k, v): (L, 1, C, KV, dh) for the engine to scatter."""
        return decoder_prefill_chunk(params, self.cfg, tokens, past_k,
                                     past_v, start)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
