"""OLMoE-1B-7B [arXiv:2409.02060] — 64-expert top-8 MoE, MHA.

16L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1024, vocab=50304.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, experts_per_token=8, moe_d_ff=1024,
    activation="swiglu", rope_theta=500_000.0,
    citation="arXiv:2409.02060",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
