"""DeepSeek-MoE-16B [arXiv:2401.06066] — fine-grained MoE:
2 shared + 64 routed experts, top-6, first layer dense.

28L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1408, vocab=102400.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    n_experts=64, experts_per_token=6, n_shared_experts=2,
    moe_d_ff=1408, first_k_dense=1, dense_d_ff=10944,
    activation="swiglu", rope_theta=10_000.0,
    citation="arXiv:2401.06066",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
