"""Parameter templates and elementary layers (plain functions on tensors).

Every parameter is declared by a ``ParamSpec(shape, dtype, axes, init)``
record in a nested-dict *template*, ``axes`` naming the logical axis of
each dim as the reference does (``repro_torch.sharding.partitioning``
resolves them onto a mesh); ``init_from_template`` materialises the
weights from a ``torch.Generator`` on that generator's device.  Layouts,
tree keys, dtypes (bf16 weights, f32 biases and norm scales) and the
places where activations go up to f32 follow ``repro.models.layers``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = [
    "ParamSpec", "init_from_template", "rms_norm", "linear", "rope_freqs",
    "apply_rope", "mlp", "mlp_template", "attention_template",
    "norm_template", "iter_specs",
]


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    axes: tuple          # logical axis name per dim (None allowed)
    init: str = "normal"  # normal | zeros | ones | ssm_a


def iter_specs(template, prefix: tuple = ()):
    """(path, spec) for every leaf, in sorted-key order (the order
    ``jax.tree.flatten`` visits a dict)."""
    for key in sorted(template):
        node = template[key]
        if isinstance(node, ParamSpec):
            yield prefix + (key,), node
        else:
            yield from iter_specs(node, prefix + (key,))


def init_from_template(template, generator: torch.Generator,
                       scale: float = 0.02):
    """Materialise parameters from a template tree on the generator's
    device: normal(0, min(scale, fan_in^-1/2)) drawn in f32 and cast, or
    zeros / ones, or ``ssm_a`` (Mamba2's A_log = log U[1, 16]).  Same
    distributions as the JAX package, not the same numbers (the weight
    bridge carries exact weights across)."""
    device = generator.device
    out: dict = {}
    for path, spec in iter_specs(template):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "ssm_a":
            u = torch.rand(spec.shape, generator=generator,
                           dtype=torch.float32, device=device) * 15.0 + 1.0
            t = torch.log(u).to(spec.dtype)
        elif spec.init == "normal":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            std = min(scale, math.sqrt(1.0 / max(1, fan_in)))
            t = (torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32, device=device) * std
                 ).to(spec.dtype)
        else:
            raise ValueError(f"unknown init {spec.init!r}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


# ---------------------------------------------------------------- templates

def norm_template(d: int, layers: int | None = None):
    shape, axes = (d,), ("embed",)
    if layers is not None:
        shape, axes = (layers, d), ("layers", "embed")
    return {"scale": ParamSpec(shape, torch.float32, axes, "ones")}


def attention_template(cfg, layers: int | None = None,
                       bias: bool | None = None):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias if bias is None else bias
    L = (layers,) if layers is not None else ()
    la = ("layers",) if layers is not None else ()
    t = {
        "wq": ParamSpec(L + (D, H * dh), torch.bfloat16,
                        la + ("embed", "heads")),
        "wk": ParamSpec(L + (D, KV * dh), torch.bfloat16,
                        la + ("embed", "kv")),
        "wv": ParamSpec(L + (D, KV * dh), torch.bfloat16,
                        la + ("embed", "kv")),
        # row-parallel under the efficient plan, replicated under exact
        "wo": ParamSpec(L + (H * dh, D), torch.bfloat16,
                        la + ("heads_out", "embed")),
    }
    if bias:
        t["bq"] = ParamSpec(L + (H * dh,), torch.float32, la + ("heads",),
                            "zeros")
        t["bk"] = ParamSpec(L + (KV * dh,), torch.float32, la + ("kv",),
                            "zeros")
        t["bv"] = ParamSpec(L + (KV * dh,), torch.float32, la + ("kv",),
                            "zeros")
    return t


def mlp_template(d_model: int, d_ff: int, activation: str,
                 layers: int | None = None):
    L = (layers,) if layers is not None else ()
    la = ("layers",) if layers is not None else ()
    t = {
        "w_in": ParamSpec(L + (d_model, d_ff), torch.bfloat16,
                          la + ("embed", "mlp")),
        "w_out": ParamSpec(L + (d_ff, d_model), torch.bfloat16,
                           la + ("mlp", "embed")),
    }
    if activation == "swiglu":
        t["w_gate"] = ParamSpec(L + (d_model, d_ff), torch.bfloat16,
                                la + ("embed", "mlp"))
    return t


# ------------------------------------------------------------------- layers

def rms_norm(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def linear(w, x, b=None):
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def mlp(params, x, activation: str):
    if activation == "swiglu":
        h = F.silu(linear(params["w_gate"], x)) * linear(params["w_in"], x)
    elif activation == "squared_relu":
        h = F.relu(linear(params["w_in"], x)).square()
    elif activation == "gelu":
        h = F.gelu(linear(params["w_in"], x), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return linear(params["w_out"], h)


# --------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].float() * freqs            # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
