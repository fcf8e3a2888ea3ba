"""SeamlessM4T-medium [arXiv:2308.11596] — enc-dec multimodal backbone.

12L encoder + 12L decoder, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=256206.  Audio frontend (mel + conv) is STUBBED: the encoder
consumes precomputed frame embeddings (assignment carve-out).
long_500k: SKIPPED — full cross-attention over a 500k-frame encoding has
no sub-quadratic decoder path without changing the architecture
(DESIGN.md Sec. 5).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab_size=256206, head_dim=64,
    activation="gelu", rope_theta=10_000.0,
    frontend="audio_frames", n_frontend_tokens=4096,
    citation="arXiv:2308.11596",
)
# NOTE: no LONG_CONTEXT defined — long_500k skip is intentional.
