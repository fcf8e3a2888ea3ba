"""Operation and byte counts the metrics divide by, and the chip's peaks.

Counts are of what the inputs need, whatever the kernels do: every byte an
input needs is read once, padding is not work, and an MoE token does the
work of its ``experts_per_token`` experts (not of the padded capacity
buffer the program fills).  A multiply-add is two operations.

``arch`` is a configuration file's ``arch`` object (``configs/*.json``).
"""

from __future__ import annotations

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES_S", "kv_bytes_per_token",
           "decode_attention_bytes", "causal_chunk_flops",
           "chunk_attention_bytes", "linear_flops_per_token",
           "head_flops_per_token", "attention_flops_per_token",
           "prefill_flops", "decode_flops"]

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth (at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

_BF16 = 2


def kv_bytes_per_token(arch: dict) -> int:
    """K and V of one token over every layer, bf16."""
    return 2 * arch["n_layers"] * arch["n_kv_heads"] * arch["head_dim"] \
        * _BF16


def decode_attention_bytes(arch: dict, keys: int, lanes: int) -> int:
    """Bytes decode attention needs over ``lanes`` lanes whose contexts
    (the new token included) hold ``keys`` tokens in all: each K and V read
    once, each query read and each output written once, every layer."""
    qo = 2 * lanes * arch["n_heads"] * arch["head_dim"] * _BF16 \
        * arch["n_layers"]
    return kv_bytes_per_token(arch) * int(keys) + qo


def causal_chunk_flops(arch: dict, start: int, length: int) -> int:
    """Attention operations of a prefill chunk of ``length`` tokens at
    positions start .. start + length - 1 over its prefix: query at
    position p sees p + 1 keys, QK^T and PV two multiply-adds a key and
    head dimension, every head and layer."""
    keys = length * start + length * (length + 1) // 2
    return 4 * arch["n_heads"] * arch["head_dim"] * arch["n_layers"] * keys


def chunk_attention_bytes(arch: dict, start: int, length: int) -> int:
    """Bytes a chunk's attention needs: its queries and outputs, and the K
    and V of the prefix and the chunk, each once, every layer."""
    qo = 2 * length * arch["n_heads"] * arch["head_dim"] * _BF16 \
        * arch["n_layers"]
    return qo + kv_bytes_per_token(arch) * (start + length)


def linear_flops_per_token(arch: dict) -> int:
    """The projections and FFN of one token through every layer: q, k, v,
    o, and the SwiGLU MLP, or the router and ``experts_per_token``
    experts.  Biases and norms are left out."""
    D, H, KV, dh = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                    arch["head_dim"])
    attn = D * H * dh * 2 + D * KV * dh * 2
    if arch.get("n_experts", 0):
        ffn = D * arch["n_experts"] \
            + arch["experts_per_token"] * 3 * D * arch["moe_d_ff"]
    else:
        ffn = 3 * D * arch["d_ff"]
    return 2 * arch["n_layers"] * (attn + ffn)


def head_flops_per_token(arch: dict) -> int:
    """The output projection of one token over the vocabulary (the
    published vocabulary, not the program's padding)."""
    return 2 * arch["d_model"] * arch["vocab_size"]


def attention_flops_per_token(arch: dict, context: int) -> int:
    """A decode token's attention over ``context`` keys."""
    return 4 * arch["n_heads"] * arch["head_dim"] * arch["n_layers"] \
        * int(context)


def prefill_flops(arch: dict, start: int, length: int) -> int:
    """A prefill chunk: its tokens' projections and FFN and its causal
    attention (no logits: a prefill computes none)."""
    return length * linear_flops_per_token(arch) \
        + causal_chunk_flops(arch, start, length)


def decode_flops(arch: dict, keys: int, lanes: int) -> int:
    """Decode over ``lanes`` lanes whose contexts (the new token included)
    hold ``keys`` tokens in all: projections, FFN, the head and the
    attention of each."""
    return lanes * (linear_flops_per_token(arch)
                    + head_flops_per_token(arch)) \
        + attention_flops_per_token(arch, keys)
