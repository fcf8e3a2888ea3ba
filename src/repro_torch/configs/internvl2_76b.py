"""InternVL2-76B [arXiv:2404.16821] — VLM: InternViT + InternLM2/Llama3-70B
language model.  Vision encoder is STUBBED (assignment carve-out): the LM
consumes precomputed patch embeddings.

LM backbone: 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672,
vocab=128256.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    activation="swiglu", rope_theta=500_000.0,
    frontend="patch_embed", n_frontend_tokens=1024,
    fsdp=True, grad_accum=8,
    citation="arXiv:2404.16821",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
