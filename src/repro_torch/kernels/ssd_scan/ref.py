"""Plain PyTorch versions of the SSD scan, used by the CPU path and the
tests, and held against the CUDA kernel on the card.

``ssd_chunked_reference`` is the torch form of
``repro/models/ssm.py::ssd_chunked`` (chunked state-space duality: a
quadratic intra-chunk term plus a carried (H, P, N) state).
``ssd_sequential_reference`` is the step-by-step recurrence of
``repro/kernels/ssd_scan/ref.py``, deliberately another algorithm, so
that agreement checks the math and not a transcription.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunked_reference", "ssd_sequential_reference"]


def ssd_chunked_reference(x, dt, a_decay, bmat, cmat, init_state=None,
                          chunk: int = 256):
    """x: (B,S,H,P); dt, a_decay: (B,S,H); bmat/cmat: (B,S,N);
    init_state: (B,H,P,N) f32 or None (zeros).  f32 inside.
    Returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) f32."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    n_chunks = -(-s // q)
    pad = n_chunks * q - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        a_decay = torch.nn.functional.pad(a_decay, (0, 0, 0, pad), value=1.0)
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, pad))

    def chunkify(t):                    # (n_chunks, B, q, ...)
        return t.reshape(b, n_chunks, q, *t.shape[2:]).movedim(1, 0)

    xc, dtc, ac = chunkify(x), chunkify(dt), chunkify(a_decay)
    bc, cc = chunkify(bmat), chunkify(cmat)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for ci in range(n_chunks):
        xq, dtq, aq = xc[ci], dtc[ci], ac[ci]
        bq, cq = bc[ci].float(), cc[ci].float()
        la = torch.log(torch.clamp(aq.float(), min=1e-20))        # (B,q,H)
        cum = torch.cumsum(la, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,q,q,H)
        lmat = torch.where(causal[None, :, :, None], torch.exp(seg),
                           torch.zeros((), device=x.device))
        scores = torch.einsum("bin,bjn->bij", cq, bq)              # (B,q,q)
        w = scores[..., None] * lmat
        xdt = xq.float() * dtq.float()[..., None]                  # (B,q,H,P)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xdt)
        decay_in = torch.exp(cum)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cq, state, decay_in)
        decay_out = torch.exp(cum[:, -1:, :] - cum)
        dstate = torch.einsum("bjn,bjhp,bjh->bhpn", bq, xdt, decay_out)
        total = torch.exp(cum[:, -1, :])
        state = state * total[:, :, None, None] + dstate
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, n_chunks * q, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_sequential_reference(x, dt, a_decay, bmat, cmat, init_state=None):
    """The same inputs and outputs as ``ssd_chunked_reference``, by the
    per-step recurrence state <- state a_t + (x_t dt_t) B_t^T,
    y_t = state C_t."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    ys = []
    for t in range(s):
        xdt = x[:, t].float() * dt[:, t].float()[..., None]        # (B,H,P)
        outer = torch.einsum("bhp,bn->bhpn", xdt, bmat[:, t].float())
        state = state * a_decay[:, t].float()[..., None, None] + outer
        ys.append(torch.einsum("bhpn,bn->bhp", state, cmat[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state
