"""Mamba2 SSD (state-space duality) block: the port of
``repro.models.ssm``.

The chunked scan goes to ``kernels.ssd_scan`` (the CUDA kernel for CUDA
tensors, the plain chunked version for CPU tensors).  The one-token
decode step and the depthwise causal conv stay plain torch ops: the
reference has no Pallas kernel for them.

Shapes: x (B,S,H,P) with H = d_inner / P heads, B/C projections shared
across heads (n_groups = 1), per-head scalar decay
a_t = exp(dt_t * -exp(A_log)).
"""

from __future__ import annotations

import torch

from ..kernels.ssd_scan.ops import ssd_scan
from ..sharding.context import constrain_inner, constrain_ssm_state
from .layers import ParamSpec

__all__ = ["ssm_template", "ssd_chunked", "ssd_decode_step", "mamba2_block",
           "mamba2_decode_step", "mamba2_inputs", "mamba2_heads",
           "mamba2_decode_inputs", "mamba2_decode_heads", "ssm_state_shape"]


def ssm_template(cfg, layers: int | None = None):
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    L = (layers,) if layers is not None else ()
    la = ("layers",) if layers is not None else ()
    return {
        "in_proj_x": ParamSpec(L + (D, DI), torch.bfloat16,
                               la + ("embed", "ssm_inner")),
        "in_proj_z": ParamSpec(L + (D, DI), torch.bfloat16,
                               la + ("embed", "ssm_inner")),
        "bc_proj": ParamSpec(L + (D, 2 * N), torch.bfloat16,
                             la + ("embed", None)),
        "dt_proj": ParamSpec(L + (D, H), torch.bfloat16, la + ("embed", None)),
        "dt_bias": ParamSpec(L + (H,), torch.float32, la + (None,), "zeros"),
        "a_log": ParamSpec(L + (H,), torch.float32, la + (None,), "ssm_a"),
        "d_skip": ParamSpec(L + (H,), torch.float32, la + (None,), "ones"),
        "conv_w": ParamSpec(L + (cfg.conv_kernel, DI), torch.float32,
                            la + (None, "ssm_inner")),
        "out_proj": ParamSpec(L + (DI, D), torch.bfloat16,
                              la + ("ssm_inner", "embed")),
    }


def ssm_state_shape(cfg, batch: int):
    """Recurrent state (B, H, P, N) + conv tail (B, K-1, DI)."""
    return {
        "ssd": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (batch, cfg.conv_kernel - 1, cfg.d_inner),
    }


def _causal_conv(x, w, tail=None, lengths=None):
    """Depthwise causal conv1d. x: (B,S,DI); w: (K,DI); tail: (B,K-1,DI).
    Products in x's dtype, summed over i = 0..K-1 in order, as the
    reference does.  With ``lengths`` (B,) the returned tail is each
    row's last K-1 valid inputs (``xp[length : length+K-1]``), so a later
    decode step resumes from the state the unpadded scan would leave."""
    k = w.shape[0]
    b, s, di = x.shape
    if tail is None:
        tail = torch.zeros((b, k - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)              # (B,S+K-1,DI)
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    if k <= 1:
        new_tail = tail
    elif lengths is None:
        new_tail = xp[:, -(k - 1):]
    else:
        idx = lengths.long()[:, None] + torch.arange(k - 1, device=x.device)
        new_tail = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, di))
    return out, new_tail


def ssd_chunked(x, dt, a_decay, bmat, cmat, init_state=None,
                chunk: int = 256):
    """Chunked SSD scan.  x: (B,S,H,P); dt: (B,S,H) (post-softplus);
    a_decay: (B,S,H) in (0, 1]; bmat/cmat: (B,S,N).
    Returns y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32."""
    return ssd_scan(x, dt, a_decay, bmat, cmat, init_state, chunk=chunk)


def ssd_decode_step(state, x, dt, a_decay, bvec, cvec, active=None):
    """One recurrent step. state: (B,H,P,N) f32; x: (B,H,P); dt, a:
    (B,H); bvec/cvec: (B,N).  Returns (y (B,H,P), new_state).

    ``active`` (B,) bool, optional, freezes the rows where it is False:
    their decay becomes 1 and their input -0.0, so state * 1 + (-0.0)
    gives back every bit of the state (x + -0.0 == x for every float,
    +0.0 included).  The select runs over this step's outer product, so
    no copy of the old state is kept and none is selected back."""
    xdt = x.float() * dt.float()[..., None]
    outer = torch.einsum("bhp,bn->bhpn", xdt, bvec.float())
    if active is not None:
        a_decay = torch.where(active[:, None], a_decay,
                              torch.ones((), device=a_decay.device))
        outer = torch.where(active[:, None, None, None], outer,
                            torch.full((), -0.0, device=outer.device))
    new_state = state * a_decay[..., None, None] + outer
    y = torch.einsum("bhpn,bn->bhp", new_state, cvec.float())
    return y.to(x.dtype), new_state


# softplus and silu in the reference's own forms (jnp.logaddexp(x, 0) and
# x * logistic(x)), written with exp, log1p of (0, 1] and the four basic
# operations: torch's CPU kernels for F.softplus and F.silu round the
# elements of a vectorised loop's scalar tail differently, so a row's
# values would depend on the padded length, while these do not.
def _softplus(x):
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x):
    return x * (1 / (1 + torch.exp(-x)))


def _dt(params, u):
    return _softplus((u @ params["dt_proj"]).float() + params["dt_bias"])


def mamba2_inputs(params, u, cfg, lengths=None):
    """The replicated half of a Mamba2 block on u (B,S,D): (B, C (B,S,N)
    each, dt and the decay a (B,S,H)), which every head reads.
    ``lengths`` as ``mamba2_block``'s: dt = 0 at pad positions."""
    n = cfg.ssm_state
    bc = u @ params["bc_proj"]                                 # (B,S,2N)
    dt = _dt(params, u)                                        # (B,S,H)
    if lengths is not None:
        valid = torch.arange(u.shape[1], device=u.device)[None, :] \
            < lengths.to(u.device)[:, None]
        dt = torch.where(valid[..., None], dt, torch.zeros((), device=u.device))
    a_decay = torch.exp(-torch.exp(params["a_log"]) * dt)      # (B,S,H)
    return bc[..., :n], bc[..., n:], dt, a_decay


def mamba2_heads(params, u, cfg, bmat, cmat, dt, a_decay, d_skip,
                 state=None, lengths=None):
    """The per-head half of a Mamba2 block: the in projections, conv, scan
    and out projection of the heads ``params`` holds (all of them, or a
    tensor-parallel shard's: in_proj_x / in_proj_z / conv_w cut on their
    inner dim, out_proj on its input dim), with dt, a_decay and d_skip of
    those heads.  Returns (out (B,S,D): the whole block's output, or the
    shard's partial sum, new_state {"ssd", "conv"})."""
    b, s, _ = u.shape
    p = cfg.ssm_head_dim
    xin = constrain_inner(u @ params["in_proj_x"])             # (B,S,DI)
    z = constrain_inner(u @ params["in_proj_z"])
    conv_tail = None if state is None else state["conv"]
    xc, new_tail = _causal_conv(xin, params["conv_w"], conv_tail,
                                lengths=lengths)
    xc = _silu(xc)
    x_heads = xc.reshape(b, s, -1, p)
    init = None if state is None else constrain_ssm_state(state["ssd"])
    y, final = ssd_chunked(x_heads, dt, a_decay, bmat, cmat,
                           init_state=init, chunk=cfg.ssm_chunk)
    final = constrain_ssm_state(final)
    y = y + x_heads * d_skip[None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, -1) * _silu(z)
    out = y @ params["out_proj"]
    return out, {"ssd": final, "conv": new_tail}


def mamba2_block(params, u, cfg, state=None, lengths=None):
    """Full Mamba2 block over a sequence. u: (B,S,D).
    Returns (out (B,S,D), new_state {"ssd", "conv"}).

    ``lengths`` (B,) marks end-padded rows' true lengths: pad positions
    get dt = 0, hence decay exp(-exp(A_log) * 0) = 1 exactly and input
    x * dt = 0, so the state passes the pads unchanged and the final
    state and every valid output equal the unpadded scan's."""
    bmat, cmat, dt, a_decay = mamba2_inputs(params, u, cfg, lengths)
    return mamba2_heads(params, u, cfg, bmat, cmat, dt, a_decay,
                        params["d_skip"], state, lengths)


def mamba2_decode_inputs(params, u, cfg):
    """The replicated half of a one-token decode step on u (B,1,D):
    (B, C (B,N), dt, a_decay (B,H))."""
    n = cfg.ssm_state
    bc = (u @ params["bc_proj"])[:, 0]
    dt = _dt(params, u)[:, 0]                                  # (B,H)
    a_decay = torch.exp(-torch.exp(params["a_log"]) * dt)
    return bc[..., :n], bc[..., n:], dt, a_decay


def mamba2_decode_heads(params, u, cfg, state, bvec, cvec, dt, a_decay,
                        d_skip, active=None):
    """The per-head half of a one-token decode step (the heads ``params``
    and ``state`` hold, as ``mamba2_heads``).  Returns (out (B,1,D) or the
    shard's partial sum, new_state)."""
    b = u.shape[0]
    p = cfg.ssm_head_dim
    xin = u @ params["in_proj_x"]                              # (B,1,DI)
    z = u @ params["in_proj_z"]
    xc, new_tail = _causal_conv(xin, params["conv_w"], state["conv"])
    if active is not None:
        new_tail = torch.where(active[:, None, None], new_tail,
                               state["conv"])
    xc = _silu(xc)[:, 0]                                      # (B,DI)
    x_heads = xc.reshape(b, -1, p)
    y, new_ssd = ssd_decode_step(state["ssd"], x_heads, dt, a_decay,
                                 bvec, cvec, active=active)
    y = y + x_heads * d_skip[None, :, None].to(y.dtype)
    y = y.reshape(b, 1, -1) * _silu(z)
    out = y @ params["out_proj"]
    return out, {"ssd": new_ssd, "conv": new_tail}


def mamba2_decode_step(params, u, cfg, state, active=None):
    """One-token decode. u: (B,1,D); state {"ssd", "conv"} per
    ``ssm_state_shape``.  ``active`` (B,) bool, optional, leaves the
    state of the rows where it is False bit-unchanged (see
    ``ssd_decode_step``; their conv tail is kept by a select)."""
    bvec, cvec, dt, a_decay = mamba2_decode_inputs(params, u, cfg)
    return mamba2_decode_heads(params, u, cfg, state, bvec, cvec, dt,
                               a_decay, params["d_skip"], active)
