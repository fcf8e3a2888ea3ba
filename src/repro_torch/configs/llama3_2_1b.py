"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3 dense GQA.

16L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    activation="swiglu", rope_theta=500_000.0, tie_embeddings=True,
    citation="hf:meta-llama/Llama-3.2-1B",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
