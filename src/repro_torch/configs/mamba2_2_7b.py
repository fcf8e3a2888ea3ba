"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD (state-space
duality). 64L, d_model=2560, ssm_state=128, head_dim=64, expand=2.

long_500k: native (constant-size recurrent state).
SageSched cost model: 'linear' (DESIGN.md Sec. 4 — no KV growth).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    citation="arXiv:2405.21060",
)

LONG_CONTEXT = CONFIG  # natively sub-quadratic
