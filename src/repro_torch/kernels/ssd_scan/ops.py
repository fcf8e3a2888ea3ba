"""Mamba2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) for CUDA tensors, the plain chunked version in
``ref.py`` for CPU tensors.

As ``repro/models/ssm.py::ssd_chunked`` does, the sequence is padded to a
whole number of chunks (chunk ``q = min(chunk, S)``) with a = 1, dt = 0
and x, B, C = 0, which carries the state through unchanged, and y is cut
back to S rows.  The kernel runs in four launches (C.B^T once per chunk,
each chunk's own state, the state from chunk to chunk, y); their scratch
is allocated here, and the call counts as one launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..grad_guard import refuse_backward
from .kernel import SSD_SCAN_KERNEL
from .ref import ssd_chunked_reference

__all__ = ["ssd_scan", "SSD_SCAN_KERNEL"]

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


def ssd_scan(x, dt, a_decay, bmat, cmat, init_state=None, *,
             chunk: int = 256):
    """x: (B,S,H,P); dt, a_decay: (B,S,H); bmat/cmat: (B,S,N);
    init_state: (B,H,P,N) f32 or None.  Returns y (B,S,H,P) in x's dtype
    and the final state (B,H,P,N) f32.

    On CUDA, x, B and C are bf16 and dt, a and the state f32, as on the
    model path.  Under autograd on the card it raises
    (``grad_guard.refuse_backward``): the kernel has no backward yet."""
    refuse_backward("ssd_scan", x, dt, a_decay, bmat, cmat, init_state)
    b, s, h, p = x.shape
    q = min(chunk, s)
    pad = -s % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        a_decay = F.pad(a_decay, (0, 0, 0, pad), value=1.0)
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    # contiguous on both paths: the CPU products then see the same layout
    # whether or not the call padded (padded == unpadded, bit for bit)
    x, dt, a_decay, bmat, cmat = (t.contiguous() for t in
                                  (x, dt, a_decay, bmat, cmat))
    dev = x.device
    if dev.type == "cpu":
        y, state = ssd_chunked_reference(x, dt, a_decay, bmat, cmat,
                                         init_state, chunk=q)
        return y[:, :s], state
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    _check(x, dt, a_decay, bmat, cmat, init_state, q)
    n = bmat.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = _scratch(b, (s + pad) // q, h, p, n, q, dev)
    SSD_SCAN_KERNEL(x.data_ptr(), dt.data_ptr(), a_decay.data_ptr(),
                    bmat.data_ptr(), cmat.data_ptr(),
                    None if init_state is None else init_state.data_ptr(),
                    y.data_ptr(), state.data_ptr(),
                    *(t.data_ptr() for t in scratch), b, s + pad, h, p, n, q,
                    torch.cuda.current_stream(dev).cuda_stream)
    SSD_SCAN_KERNEL.launches += 1
    return y[:, :s], state


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
