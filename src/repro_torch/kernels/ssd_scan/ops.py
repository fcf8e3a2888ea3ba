"""Mamba2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) for CUDA tensors, the plain chunked version in
``ref.py`` for CPU tensors.

As ``repro/models/ssm.py::ssd_chunked`` does, the sequence is padded to a
whole number of chunks (chunk ``q = min(chunk, S)``) with a = 1, dt = 0
and x, B, C = 0, which carries the state through unchanged, and y is cut
back to S rows.  The kernel runs in four launches (C.B^T once per chunk,
each chunk's own state, the state from chunk to chunk, y); their scratch
is allocated here, and the call counts as one launch.

Under autograd (grad enabled and an input requiring grad) the padded scan
goes through ``SSDScanFunction``: its forward is the same kernel call,
saving the padded inputs, and its backward one call of
``SSD_BACKWARD_KERNEL`` (``csrc/ssd_scan_bwd.cu``: seven launches on the
tensor cores, their scratch allocated here, counted as one), which
recomputes the chunk states in f32 rather than keeping the forward's.
The padding and the cut stay outside the Function, so autograd takes
their gradients.  On the CPU the same Function runs the plain versions
(``ssd_chunked_reference``, ``ssd_backward_reference``).  On the meta
device inside ``build.shape_pass`` (the dry-run) the scan is
``ssd_chunked_batched_reference``, differentiated by autograd.  A build
or launch error raises; nothing falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..build import plain_here
from .kernel import SSD_BACKWARD_KERNEL, SSD_SCAN_KERNEL
from .ref import (ssd_backward_reference, ssd_chunked_batched_reference,
                  ssd_chunked_reference)

__all__ = ["ssd_scan", "ssd_scan_backward", "SSDScanFunction",
           "SSD_SCAN_KERNEL", "SSD_BACKWARD_KERNEL"]

# (P, N) pairs the kernel is instantiated for: mamba2-2.7b, zamba2-1.2b,
# and the reduced configs of both
SHAPES = ((64, 128), (64, 64), (32, 16))
MAX_CHUNK = 256
# the kernel's tile rows (kT: a chunk is cut into 64-row tiles) and the
# bf16 parts of the carried state in its scratch (kPS)
TILE = 64
STATE_PARTS = 2


def _check(x, dt, a_decay, bmat, cmat, init_state, q):
    dev = x.device
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (p, n) not in SHAPES or q > MAX_CHUNK:
        raise ValueError(f"ssd_scan: unsupported (P, N) = ({p}, {n}) or "
                         f"chunk {q} (kernel has {SHAPES}, chunk <= "
                         f"{MAX_CHUNK})")
    if dt.shape != (b, s, h) or a_decay.shape != (b, s, h) \
            or bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(f"ssd_scan: mismatched shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a_decay.shape)} B "
                         f"{tuple(bmat.shape)} C {tuple(cmat.shape)}")
    named = [("x", x, torch.bfloat16), ("dt", dt, torch.float32),
             ("a_decay", a_decay, torch.float32),
             ("bmat", bmat, torch.bfloat16), ("cmat", cmat, torch.bfloat16)]
    if init_state is not None:
        if init_state.shape != (b, h, p, n):
            raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)}"
                             f" is not {(b, h, p, n)}")
        named.append(("init_state", init_state, torch.float32))
    for name, t, dtype in named:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def _whole_chunks(q, x, dt, a_decay, bmat, cmat, *more):
    """The inputs (and ``more`` row tensors, padded as x) padded to a whole
    number of chunks of q rows, as ``repro/models/ssm.py::ssd_chunked``
    pads: a = 1, everything else 0, which carries the state through
    unchanged; all contiguous (the CPU products then see the same layout
    whether or not the call padded: padded == unpadded, bit for bit)."""
    pad = -x.shape[1] % q
    ts = (x, dt, a_decay, bmat, cmat) + more
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad),
                       value=1.0 if t is a_decay else 0.0).contiguous()
                 if pad else t.contiguous() for t in ts)


def ssd_scan(x, dt, a_decay, bmat, cmat, init_state=None, *,
             chunk: int = 256):
    """x: (B,S,H,P); dt, a_decay: (B,S,H); bmat/cmat: (B,S,N);
    init_state: (B,H,P,N) f32 or None.  Returns y (B,S,H,P) in x's dtype
    and the final state (B,H,P,N) f32.

    On CUDA, x, B and C are bf16 and dt, a and the state f32, as on the
    model path.  With grad enabled and an input requiring grad the scan
    goes through ``SSDScanFunction`` (the backward kernel on the card)."""
    s = x.shape[1]
    q = min(chunk, s)
    if x.device.type == "meta" and plain_here(x.device):
        return ssd_chunked_batched_reference(x, dt, a_decay, bmat, cmat,
                                             init_state, chunk=q)
    ts = _whole_chunks(q, x, dt, a_decay, bmat, cmat) + (init_state,)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        y, state = SSDScanFunction.apply(*ts, q)
    else:
        y, state = _scan(*ts, q)
    return y[:, :s], state


def _scan(x, dt, a_decay, bmat, cmat, init_state, q):
    """The scan of padded, contiguous inputs (S a multiple of q)."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_chunked_reference(x, dt, a_decay, bmat, cmat, init_state,
                                     chunk=q)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    _check(x, dt, a_decay, bmat, cmat, init_state, q)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = _scratch(b, s // q, h, p, n, q, dev)
    SSD_SCAN_KERNEL(x.data_ptr(), dt.data_ptr(), a_decay.data_ptr(),
                    bmat.data_ptr(), cmat.data_ptr(),
                    None if init_state is None else init_state.data_ptr(),
                    y.data_ptr(), state.data_ptr(),
                    *(t.data_ptr() for t in scratch), b, s, h, p, n, q,
                    torch.cuda.current_stream(dev).cuda_stream)
    SSD_SCAN_KERNEL.launches += 1
    return y, state


def ssd_scan_backward(x, dt, a_decay, bmat, cmat, init_state, dy,
                      dstate=None, *, chunk: int = 256):
    """The gradients (dx, ddt, da, dB, dC, dinit) of ``ssd_scan`` at its
    inputs for the output gradients ``dy`` (B,S,H,P) in y's dtype and
    ``dstate`` (B,H,P,N) f32 or None (zeros), each in its input's dtype;
    dinit None without ``init_state``.  On CUDA one call of the backward
    kernel (tensor-core products, each f32 factor in two bf16 parts;
    deterministic: no atomics, two calls bit-identical), on the CPU
    ``ssd_backward_reference``; padded to whole chunks as the forward is."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_backward_reference(x, dt, a_decay, bmat, cmat, init_state,
                                      dy, dstate, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_backward: unsupported device {dev}")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    x, dt, a_decay, bmat, cmat, dy = _whole_chunks(q, x, dt, a_decay, bmat,
                                                   cmat, dy)
    _check(x, dt, a_decay, bmat, cmat, init_state, q)
    for name, t, shape, dtype in (("dy", dy, x.shape, x.dtype),
                                  ("dstate", dstate, (b, h, p, n),
                                   torch.float32)):
        if t is not None and (t.shape != shape or t.device != dev
                              or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"ssd_scan_backward: {name} must be a "
                             f"contiguous {dtype} tensor of shape "
                             f"{tuple(shape)} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    nc = x.shape[1] // q
    dx, ddt, da, dbm, dcm = (torch.empty_like(t) for t in
                             (x, dt, a_decay, bmat, cmat))
    dinit = None if init_state is None else torch.empty_like(init_state)
    scratch = _backward_scratch(b, nc, h, p, n, q, dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    SSD_BACKWARD_KERNEL(*(ptr(t) for t in (
        x, dt, a_decay, bmat, cmat, init_state, dy, dstate, dx, ddt, da,
        dbm, dcm, dinit) + scratch), b, x.shape[1], h, p, n, q,
        torch.cuda.current_stream(dev).cuda_stream)
    SSD_BACKWARD_KERNEL.launches += 1
    return dx[:, :s], ddt[:, :s], da[:, :s], dbm[:, :s], dcm[:, :s], dinit


class SSDScanFunction(torch.autograd.Function):
    """The padded scan under autograd: ``_scan`` forward (the serving
    kernel call; the padded inputs saved), ``ssd_scan_backward`` backward.
    The chunk gets no gradient; a final-state gradient that autograd
    leaves None (training discards the state) counts as zeros."""

    @staticmethod
    def forward(ctx, x, dt, a_decay, bmat, cmat, init_state, q):
        ctx.set_materialize_grads(False)
        y, state = _scan(x, dt, a_decay, bmat, cmat, init_state, q)
        ctx.save_for_backward(x, dt, a_decay, bmat, cmat, init_state)
        ctx.q = q
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_decay, bmat, cmat, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None \
            else dy.to(x.dtype).contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        grads = ssd_scan_backward(x, dt, a_decay, bmat, cmat, init_state,
                                  dy, dstate, chunk=ctx.q)
        return (*grads, None)


def _backward_scratch(b, nc, h, p, n, q, dev):
    """The backward kernel's scratch, qp = q rounded up to TILE and nt =
    qp / TILE tiles: cum and dt of each (chunk, head) (B, nc, H, 2, qp);
    G^T = B C^T of each chunk (B, nc, qp, qp); each chunk's own state and
    own state gradient (B, nc, H, 2, P, N); the state carried in and the
    state gradient leaving, in bf16 parts (B, nc, H, 2, STATE_PARTS, P, N);
    exp(cum_last) <dS_out, S> (B, nc, H); dcum's terms by row (B, nc, H,
    3 + nt, qp); dG's products with C and B by tile pair (B, nc, 2,
    nt (nt + 1) / 2, TILE, N).  All f32 but the parts."""
    qp = -(-q // TILE) * TILE
    nt = qp // TILE
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((b, nc, h, 2, qp), **f32),
            torch.empty((b, nc, qp, qp), **f32),
            torch.empty((b, nc, h, 2, p, n), **f32),
            torch.empty((b, nc, h, 2, STATE_PARTS, p, n),
                        dtype=torch.bfloat16, device=dev),
            torch.empty((b, nc, h), **f32),
            torch.empty((b, nc, h, 3 + nt, qp), **f32),
            torch.empty((b, nc, 2, nt * (nt + 1) // 2, TILE, n), **f32))


def _scratch(b, nc, h, p, n, q, dev):
    """The kernel's scratch, qp = q rounded up to TILE: cum and dt of each
    (chunk, head) (B, nc, H, 2, qp) f32; C.B^T of each chunk (B, nc, qp,
    qp) f32; each chunk's own state (B, nc, H, P, N) f32; the state carried
    into each chunk in bf16 parts (B, nc, H, STATE_PARTS, P, N)."""
    qp = -(-q // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((b, nc, h, 2, qp), **f32),
            torch.empty((b, nc, qp, qp), **f32),
            torch.empty((b, nc, h, p, n), **f32),
            torch.empty((b, nc, h, STATE_PARTS, p, n), dtype=torch.bfloat16,
                        device=dev))
