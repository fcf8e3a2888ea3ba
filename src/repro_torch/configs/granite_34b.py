"""Granite-34B-Code [arXiv:2405.04324] — llama-arch code model with MQA.

88L, d_model=6144, 48 heads (GQA kv=1 = multi-query), d_ff=24576 (4x, GELU
non-gated per GPTBigCode lineage), vocab=49152.
NOTE: upstream uses learned absolute positions; we use RoPE uniformly
(recorded deviation, DESIGN.md Sec. 7).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    activation="gelu", rope_theta=100_000.0,
    fsdp=True, grad_accum=4,
    citation="arXiv:2405.04324",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
