"""Nemotron-4-340B [arXiv:2402.16819] — dense GQA with squared-ReLU MLP.

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab=256000.
Distribution: FSDP (layers over 'data') + tensor parallel; grad_accum=16;
bf16 Adam moments (DESIGN.md memory budget).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    activation="squared_relu", rope_theta=500_000.0,
    fsdp=True, grad_accum=16, moment_dtype="bfloat16",
    citation="arXiv:2402.16819",
)

LONG_CONTEXT = CONFIG.with_overrides(attention_kind="sliding_window",
                                     window=8192)
