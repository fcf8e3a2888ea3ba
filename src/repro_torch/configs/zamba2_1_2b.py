"""Zamba2-1.2B [arXiv:2411.15242] — hybrid: Mamba2 backbone + shared
attention block applied periodically.

38 Mamba2 layers, d_model=2048; shared attn block: 32 heads (kv=32,
MHA), d_ff=8192; ssm_state=64; vocab=32000.
long_500k: native for the SSM path; the shared attention applications use
the sliding-window variant at 500k (DESIGN.md Sec. 5).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6,
    activation="swiglu", rope_theta=10_000.0,
    citation="arXiv:2411.15242",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
