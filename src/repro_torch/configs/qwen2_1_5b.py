"""Qwen2-1.5B [arXiv:2407.10671] — dense GQA decoder with QKV bias.

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    activation="swiglu", qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="arXiv:2407.10671",
)

# long_500k: sliding-window variant (DESIGN.md Sec. 5)
LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
