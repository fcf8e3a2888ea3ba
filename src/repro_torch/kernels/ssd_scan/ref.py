"""Plain PyTorch versions of the SSD scan, used by the CPU path and the
tests, and held against the CUDA kernel on the card.

``ssd_chunked_reference`` is the torch form of
``repro/models/ssm.py::ssd_chunked`` (chunked state-space duality: a
quadratic intra-chunk term plus a carried (H, P, N) state).
``ssd_sequential_reference`` is the step-by-step recurrence of
``repro/kernels/ssd_scan/ref.py``, deliberately another algorithm, so
that agreement checks the math and not a transcription.
``ssd_passes_reference`` computes the scan as ``csrc/ssd_scan.cu`` does:
its four passes, its 64-row tiles and the bf16 parts it takes of each
f32 factor, so that the precision of that design is tested on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked_reference", "ssd_sequential_reference",
           "ssd_passes_reference"]

TILE = 64     # the kernel's tile rows


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


def _bf16_parts(t, parts: int):
    """An f32 factor as the kernel feeds it to the tensor cores: ``parts``
    bf16 values (as f32), each the bf16 of what the earlier ones leave."""
    out = []
    for _ in range(parts):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out


def ssd_passes_reference(x, dt, a_decay, bmat, cmat, init_state=None,
                         chunk: int = 256, w_parts: int = 3,
                         parts: int = 2):
    """The scan as ``csrc/ssd_scan.cu`` computes it, in f32 with each f32
    factor rounded to its bf16 parts (``w_parts`` for W, ``parts`` for
    B_j f_j and the carried state, as the kernel's kPW, kPB and kPS); the
    same inputs and outputs as ``ssd_chunked_reference``.

    Each batch row on its own; chunks of q rows cut into TILE-row tiles,
    rows past q zero (cum constant, dt 0).  The passes: (1) C.B^T once per
    chunk; (2) cum, f_j = dt_j exp(cum_{q-1} - cum_j) and each chunk's own
    state sum over j tiles of x_j^T (B_j f_j), B_j f_j in parts; (3) the
    state from chunk to chunk, state exp(cum_{q-1}) + that sum, the state
    carried into each chunk in parts; (4) per i tile, exp(cum_i) C_i .
    state (skipped where nothing is carried in), then the j tiles <= i in
    order, W = (C.B^T) exp(cum_i - cum_j) dt_j (j <= i) in parts, against
    x.  One part each rounds every factor to bf16 alone (what the parts
    are for)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    qp = -(-q // TILE) * TILE
    n_tiles = qp // TILE

    def chunks(t, value=0.0):           # (nc, qp, ...), rows past q zero
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)
        t = t.reshape(nc, q, *t.shape[2:])
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, qp - q), value=value)

    causal = torch.tril(torch.ones((qp, qp), dtype=torch.bool,
                                   device=x.device))
    ys, finals = [], []
    for r in range(b):
        xr = chunks(x[r:r + 1].float())                     # (nc, qp, H, P)
        dtr = chunks(dt[r:r + 1].float())                   # (nc, qp, H)
        la = torch.log(torch.clamp(a_decay[r:r + 1].float(), min=1e-20))
        cum = torch.cumsum(chunks(la), dim=1)               # (nc, qp, H)
        br = chunks(bmat[r:r + 1].float())                  # (nc, qp, N)
        cr = chunks(cmat[r:r + 1].float())
        # (1) C.B^T of each chunk
        cb = torch.einsum("cin,cjn->cij", cr, br)
        # (2) each chunk's own state
        last = cum[:, q - 1:q]                              # (nc, 1, H)
        f = dtr * torch.exp(last - cum)
        ds = []
        for c in range(nc):
            acc = torch.zeros((h, p, n), dtype=torch.float32,
                              device=x.device)
            for jt in range(n_tiles):
                j = slice(jt * TILE, (jt + 1) * TILE)
                for part in _bf16_parts(
                        br[c, j, None, :] * f[c, j, :, None], parts):
                    acc = acc + torch.einsum("jhp,jhn->hpn", xr[c, j], part)
            ds.append(acc)
        # (3) the state from chunk to chunk
        state = torch.zeros((h, p, n), dtype=torch.float32,
                            device=x.device) if init_state is None \
            else init_state[r].float()
        carried = []
        for c in range(nc):
            carried.append(_bf16_parts(state, parts))
            state = state * torch.exp(cum[c, q - 1])[:, None, None] + ds[c]
        finals.append(state)
        # (4) y, one i tile at a time
        yr = []
        for c in range(nc):
            for it in range(n_tiles):
                i = slice(it * TILE, (it + 1) * TILE)
                acc = torch.zeros((TILE, h, p), dtype=torch.float32,
                                  device=x.device)
                if init_state is not None or c > 0:
                    for part in carried[c]:
                        acc = acc + torch.einsum("in,hpn->ihp", cr[c, i],
                                                 part)
                    acc = acc * torch.exp(cum[c, i])[:, :, None]
                for jt in range(it + 1):
                    j = slice(jt * TILE, (jt + 1) * TILE)
                    seg = cum[c, i, None, :] - cum[c, None, j, :]
                    w = cb[c, i, j, None] * torch.exp(seg) \
                        * dtr[c, None, j, :]                # (Ti, Tj, H)
                    w = torch.where(causal[i, j, None], w,
                                    torch.zeros((), device=x.device))
                    for part in _bf16_parts(w, w_parts):
                        acc = acc + torch.einsum("ijh,jhp->ihp", part,
                                                 xr[c, j])
                yr.append(acc)
            # keep the chunk's q rows
            yr[-n_tiles:] = [torch.cat(yr[-n_tiles:])[:q]]
        ys.append(torch.cat(yr)[:s])
    return torch.stack(ys).to(x.dtype), torch.stack(finals)
