"""Model configuration covering every assigned architecture family."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["ModelConfig", "FAMILIES"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Fields cover dense GQA decoders, MoE, Mamba2 SSD,
    hybrid SSM+attention, encoder-decoder, and VLM backbones."""

    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    citation: str = ""

    # activations / layout
    activation: str = "swiglu"       # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention variant (long-context)
    attention_kind: str = "full"     # full | sliding_window
    window: int = 8192

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_k_dense: int = 0           # leading dense layers (DeepSeek-MoE)
    dense_d_ff: int = 0              # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # hybrid (Zamba2): a shared attention+MLP block applied every k layers
    hybrid_attn_every: int = 6

    # encoder-decoder
    n_encoder_layers: int = 0

    # modality frontend stub (audio frames / vision patches)
    frontend: str = ""               # "" | "audio_frames" | "patch_embed"
    n_frontend_tokens: int = 0       # patches/frames consumed at prefill

    # distribution / memory knobs
    fsdp: bool = False               # shard stacked-layer params over data
    grad_accum: int = 1
    remat: bool = True
    moment_dtype: str = "float32"    # adam moments ("bfloat16" for >=100B)

    # model-parallel submesh size these configs assume (mesh 'model' axis)
    model_parallel: int = 16

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"bad family {self.family!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----------------------------------------------------------- derived

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the 'vocab' axis shards
        evenly over any mesh (MaxText-style logits padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Can serve 500k-token contexts sub-quadratically?"""
        return (self.family in ("ssm", "hybrid")
                or self.attention_kind == "sliding_window")

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        D, V = self.d_model, self.vocab_size
        emb = V * D * (1 if self.tie_embeddings else 2)
        n = emb
        dh = self.head_dim
        attn = D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh \
            + self.n_heads * dh * D
        gate = 3 if self.activation == "swiglu" else 2
        dense_ffn = gate * D * self.d_ff

        def moe_ffn(layers):
            per = gate * D * self.moe_d_ff
            shared = self.n_shared_experts * per
            routed = self.n_experts * per
            router = D * self.n_experts
            return layers * (routed + shared + router)

        if self.family == "dense" or self.family == "vlm":
            n += self.n_layers * (attn + dense_ffn)
        elif self.family == "moe":
            moe_layers = self.n_layers - self.first_k_dense
            n += self.n_layers * attn
            n += self.first_k_dense * gate * D * (self.dense_d_ff or self.d_ff)
            n += moe_ffn(moe_layers)
        elif self.family == "ssm":
            per = (D * 2 * self.d_inner            # in_proj (x, z)
                   + 2 * D * self.ssm_state        # B, C proj
                   + D * self.ssm_heads            # dt
                   + self.d_inner * D)             # out_proj
            n += self.n_layers * per
        elif self.family == "hybrid":
            per = (D * 2 * self.d_inner + 2 * D * self.ssm_state
                   + D * self.ssm_heads + self.d_inner * D)
            n += self.n_layers * per + (attn + dense_ffn)  # one shared block
        elif self.family == "encdec":
            n += self.n_encoder_layers * (attn + dense_ffn)
            n += self.n_layers * (2 * attn + dense_ffn)  # self + cross
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        gate = 3 if self.activation == "swiglu" else 2
        per = gate * D * self.moe_d_ff
        moe_layers = self.n_layers - self.first_k_dense
        inactive = moe_layers * (self.n_experts - self.experts_per_token) * per
        return self.param_count() - inactive

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
        dh = 64
        heads = max(2, min(4, self.n_heads))
        kv = 1 if self.n_kv_heads == 1 else (heads if self.n_kv_heads >= self.n_heads else max(1, heads // 2))
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2, d_model=256, n_heads=heads, n_kv_heads=kv,
            head_dim=dh, d_ff=512, vocab_size=512,
            n_encoder_layers=min(2, self.n_encoder_layers),
            window=64, fsdp=False, grad_accum=1, model_parallel=1,
            n_frontend_tokens=min(16, self.n_frontend_tokens),
        )
        if self.family == "moe":
            kw.update(n_experts=4, experts_per_token=2,
                      n_shared_experts=min(1, self.n_shared_experts),
                      moe_d_ff=128, first_k_dense=min(1, self.first_k_dense),
                      dense_d_ff=256)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16,
                      hybrid_attn_every=1)
        return replace(self, **kw)
