"""Plain PyTorch versions of the SSD scan, used by the CPU path and the
tests, and held against the CUDA kernel on the card.

``ssd_chunked_reference`` is the torch form of
``repro/models/ssm.py::ssd_chunked`` (chunked state-space duality: a
quadratic intra-chunk term plus a carried (H, P, N) state).
``ssd_chunked_batched_reference`` is the same arithmetic with every
chunk's own terms computed at once and only the carried state stepped
chunk by chunk: the plain version the dry-run's shape pass takes on the
meta device, where each op costs the same whatever its size.
``ssd_sequential_reference`` is the step-by-step recurrence of
``repro/kernels/ssd_scan/ref.py``, deliberately another algorithm, so
that agreement checks the math and not a transcription.
``ssd_passes_reference`` computes the scan as ``csrc/ssd_scan.cu`` does:
its four passes, its 64-row tiles and the bf16 parts it takes of each
f32 factor, so that the precision of that design is tested on the CPU.
``ssd_backward_reference`` is the chunked scan's backward written out in
f32 (no autograd): the plain version of ``csrc/ssd_scan_bwd.cu``.
``ssd_backward_passes_reference`` computes that backward as the kernel's
passes do: the same terms, each f32 factor of a tensor-core product
rounded to its bf16 parts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked_reference", "ssd_chunked_batched_reference",
           "ssd_sequential_reference",
           "ssd_passes_reference", "ssd_backward_reference",
           "ssd_backward_passes_reference"]

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
        # exp of the causal entries only: the masked ones (seg > 0, which
        # can overflow) go in as -inf, so their exp is 0 and so is its
        # gradient (exp(seg) masked afterwards gives the same forward but
        # a NaN gradient, 0 * inf, once seg overflows: ROADMAP Queue C R7)
        lmat = torch.exp(torch.where(causal[None, :, :, None], seg,
                                     torch.full((), -torch.inf,
                                                device=x.device)))
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


def ssd_chunked_batched_reference(x, dt, a_decay, bmat, cmat,
                                  init_state=None, chunk: int = 256):
    """``ssd_chunked_reference`` with the chunk loop taken out of
    everything but the carried state: the same inputs, outputs and terms,
    each chunk's (B, q, q, H) decay matrix, scores, own state and y terms
    computed for all chunks in one op each."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        a_decay = F.pad(a_decay, (0, 0, 0, pad), value=1.0)
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))

    def chunkify(t):                    # (B, n_chunks, q, ...)
        return t.reshape(b, nc, q, *t.shape[2:])

    xc, dtc, ac = chunkify(x), chunkify(dt), chunkify(a_decay)
    bc, cc = chunkify(bmat).float(), chunkify(cmat).float()
    la = torch.log(torch.clamp(ac.float(), min=1e-20))           # (B,c,q,H)
    cum = torch.cumsum(la, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,c,q,q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    lmat = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                 torch.full((), -torch.inf,
                                            device=x.device)))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    w = scores[..., None] * lmat
    xdt = xc.float() * dtc.float()[..., None]                    # (B,c,q,H,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)
    own = torch.einsum("bcjn,bcjhp,bcjh->bchpn", bc, xdt, decay_out)
    total = torch.exp(cum[:, :, -1, :])                          # (B,c,H)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    carried = []
    for ci in range(nc):
        carried.append(state)
        state = state * total[:, ci, :, None, None] + own[:, ci]
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc,
                           torch.stack(carried, dim=1), torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :s]
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


def ssd_backward_reference(x, dt, a_decay, bmat, cmat, init_state, dy,
                           dstate=None, chunk: int = 256):
    """The gradients of ``ssd_chunked_reference``'s (y, final state) for
    the output gradients ``dy`` (B,S,H,P) and ``dstate`` (B,H,P,N) or None
    (zeros): (dx, ddt, da, dB, dC, dinit), each in its input's dtype,
    dinit None without ``init_state``.  f32 inside, written out per chunk
    (the padding as the forward's, its rows' gradients cut off).

    In a chunk of q rows, with S the state carried in, dS_out the
    gradient of the state leaving it, E_ij = exp(cum_i - cum_j) for j <= i
    (exp is never taken above the diagonal, where the segment sums can
    overflow), G = C B^T, W = G E, xdt_j = x_j dt_j and g_j = exp(cum_last
    - cum_j):

      dS (into the chunk) = exp(cum_last) dS_out + sum_i exp(cum_i) dy_i C_i^T
      dxdt_j = sum_{i>=j} W_ij dy_i + g_j dS_out B_j
      dC_i = sum_j dG_ij B_j + exp(cum_i) S^T dy_i, dG = <dy_i, xdt_j> E
      dB_j = sum_i dG_ij C_i + g_j dS_out^T xdt_j        (both over heads)
      dcum = row sums - column sums of dW * W, + exp(cum_i) <dy_i, S C_i>,
             - g_j <dS_out, xdt_j B_j^T>, and on the last row the sum of
             the latter and exp(cum_last) <dS_out, S>

    then dla is the reverse cumsum of dcum within the chunk and da = dla /
    a where a > 1e-20, else 0 (the clamp of log a)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    f = [t.float() for t in (x, dt, a_decay, bmat, cmat, dy)]
    if pad:
        f = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad),
                   value=1.0 if i == 2 else 0.0) for i, t in enumerate(f)]
    xc, dtc, ac, bc, cc, dyc = (
        t.reshape(b, nc, q, *t.shape[2:]).movedim(1, 0) for t in f)
    dev = x.device
    cum = torch.cumsum(torch.log(torch.clamp(ac, min=1e-20)), dim=2)
    last = cum[:, :, -1]                                    # (nc, B, H)
    xdt = xc * dtc[..., None]                               # (nc,B,q,H,P)
    g = torch.exp(last[:, :, None] - cum)                   # (nc,B,q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    states = []
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev) \
        if init_state is None else init_state.float()
    for c in range(nc):
        states.append(state)
        state = state * torch.exp(last[c])[..., None, None] + torch.einsum(
            "bjn,bjhp,bjh->bhpn", bc[c], xdt[c], g[c])
    d_out = torch.zeros_like(state) if dstate is None else dstate.float()
    grads = {k: [None] * nc for k in ("x", "dt", "a", "b", "c")}
    for c in reversed(range(nc)):
        cu, st, dyq = cum[c], states[c], dyc[c]
        seg = cu[:, :, None, :] - cu[:, None, :, :]            # (B,q,q,H)
        e_mat = torch.exp(torch.where(causal[None, :, :, None], seg,
                                      torch.full((), -torch.inf,
                                                 device=dev)))
        w = torch.einsum("bin,bjn->bij", cc[c], bc[c])[..., None] * e_mat
        e_in = torch.exp(cu)                                   # (B,q,H)
        dxdt = torch.einsum("bijh,bihp->bjhp", w, dyq) + g[c][..., None] \
            * torch.einsum("bhpn,bjn->bjhp", d_out, bc[c])
        d_w = torch.einsum("bihp,bjhp->bijh", dyq, xdt[c])
        d_g = d_w * e_mat
        grads["c"][c] = torch.einsum("bijh,bjn->bin", d_g, bc[c]) \
            + torch.einsum("bih,bhpn,bihp->bin", e_in, st, dyq)
        grads["b"][c] = torch.einsum("bijh,bin->bjn", d_g, cc[c]) \
            + torch.einsum("bjh,bhpn,bjhp->bjn", g[c], d_out, xdt[c])
        d_seg = d_w * w
        dcum = d_seg.sum(2) - d_seg.sum(1)
        dcum = dcum + e_in * torch.einsum("bihp,bhpn,bin->bih", dyq, st,
                                          cc[c])
        gdg = g[c] * torch.einsum("bhpn,bjhp,bjn->bjh", d_out, xdt[c],
                                  bc[c])
        dcum = dcum - gdg
        dcum[:, -1] += gdg.sum(1) + torch.exp(last[c]) \
            * (d_out * st).sum((-1, -2))
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        grads["a"][c] = torch.where(ac[c] > 1e-20, dla / ac[c],
                                    torch.zeros((), device=dev))
        grads["x"][c] = dxdt * dtc[c][..., None]
        grads["dt"][c] = (dxdt * xc[c]).sum(-1)
        d_out = torch.exp(last[c])[..., None, None] * d_out + torch.einsum(
            "bih,bihp,bin->bhpn", e_in, dyq, cc[c])

    def whole(parts, like):
        t = torch.stack(parts, dim=1)
        return t.reshape(b, nc * q, *t.shape[3:])[:, :s].to(like.dtype)

    return (whole(grads["x"], x), whole(grads["dt"], dt),
            whole(grads["a"], a_decay), whole(grads["b"], bmat),
            whole(grads["c"], cmat),
            None if init_state is None else d_out.to(init_state.dtype))


def _parts_sum(t, parts: int):
    """t as the sum of its ``parts`` bf16 parts (exact in f32): the value
    that the kernel's products of those parts, one a part, take."""
    return sum(_bf16_parts(t, parts))


def ssd_backward_passes_reference(x, dt, a_decay, bmat, cmat, init_state,
                                  dy, dstate=None, chunk: int = 256,
                                  parts: int = 2):
    """The gradients of ``ssd_backward_reference`` as ``csrc/
    ssd_scan_bwd.cu`` computes them, pass by pass, in f32 with each f32
    factor of a tensor-core product rounded to its ``parts`` bf16 parts
    (the kernel's kParts); the same inputs and outputs.

    (1) cum, f_j = dt_j g_j and e_i = exp(cum_i); each chunk's own state
    x^T (B_j f_j) and own state gradient dy^T (C_i e_i), B_j f_j and C_i e_i
    in parts; (3) the state carried into each chunk and the gradient of the
    state leaving it, chunk by chunk in f32, each kept in parts, and
    exp(cum_last) <dS_out, S> (S in parts); (4) dxdt_j = g_j (dS_out B_j) +
    W^T dy with W in parts, dW = (dy x^T) dt_j exact, the row and column
    sums of dW W, gdg_j = g_j dt_j <x_j, dS_out B_j>; (5) dG summed over
    the heads, in parts, times B (dC's part) and C (dB's part); (6) dB's
    row term sum_h g_j dt_j (x_j dS_out) and dC's sum_h e_i (dy_i S), and
    e_i <C_i, dy_i S>; (7) dcum, its reverse cumsum, da.  The kernel's
    sums run in its tiles' fixed order, these in torch's: they differ
    only in f32 rounding.  Padded rows as the forward's."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    f = [t.float() for t in (x, dt, a_decay, bmat, cmat, dy)]
    if pad:
        f = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad),
                   value=1.0 if i == 2 else 0.0) for i, t in enumerate(f)]
    xc, dtc, ac, bc, cc, dyc = (
        t.reshape(b, nc, q, *t.shape[2:]).movedim(1, 0) for t in f)
    dev = x.device
    # (1)
    cum = torch.cumsum(torch.log(torch.clamp(ac, min=1e-20)), dim=2)
    last = cum[:, :, -1]                                    # (nc, B, H)
    g = torch.exp(last[:, :, None] - cum)                   # (nc,B,q,H)
    e_in = torch.exp(cum)
    own = torch.einsum("cbjhp,cbjhn->cbhpn", xc, _parts_sum(
        bc[:, :, :, None, :] * (dtc * g)[..., None], parts))
    own_d = torch.einsum("cbihp,cbihn->cbhpn", dyc, _parts_sum(
        cc[:, :, :, None, :] * e_in[..., None], parts))
    # (3)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev) \
        if init_state is None else init_state.float()
    carried = []
    for c in range(nc):
        carried.append(_parts_sum(state, parts))
        state = state * torch.exp(last[c])[..., None, None] + own[c]
    grad = torch.zeros_like(state) if dstate is None else dstate.float()
    d_out, extra = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        d_out[c] = _parts_sum(grad, parts)
        extra[c] = torch.exp(last[c]) * (grad * carried[c]).sum((-1, -2))
        grad = grad * torch.exp(last[c])[..., None, None] + own_d[c]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    grads = {k: [None] * nc for k in ("x", "dt", "a", "b", "c")}
    for c in range(nc):
        xq, dtq, dyq, bq, cq = xc[c], dtc[c], dyc[c], bc[c], cc[c]
        seg = cum[c][:, :, None, :] - cum[c][:, None, :, :]   # (B,i,j,H)
        e_mat = torch.exp(torch.where(causal[None, :, :, None], seg,
                                      torch.full((), -torch.inf,
                                                 device=dev)))
        w = torch.einsum("bin,bjn->bij", cq, bq)[..., None] * e_mat
        # (4)
        row = torch.einsum("bjn,bhpn->bjhp", bq, d_out[c])
        gdg = g[c] * dtq * (xq * row).sum(-1)
        dxdt = g[c][..., None] * row + torch.einsum(
            "bijh,bihp->bjhp", _parts_sum(w, parts), dyq)
        d_w = torch.einsum("bihp,bjhp->bijh", dyq, xq) * dtq[:, None]
        d_seg = d_w * w
        # (5)
        d_g = _parts_sum((d_w * e_mat).sum(-1), parts)         # (B,i,j)
        # (6)
        t_b = torch.einsum("bjhp,bhpn->bjhn", xq, d_out[c])
        t_c = torch.einsum("bihp,bhpn->bihn", dyq, carried[c])
        grads["b"][c] = torch.einsum("bij,bin->bjn", d_g, cq) \
            + torch.einsum("bjh,bjhn->bjn", g[c] * dtq, t_b)
        grads["c"][c] = torch.einsum("bij,bjn->bin", d_g, bq) \
            + torch.einsum("bih,bihn->bin", e_in[c], t_c)
        # (7)
        dcum = d_seg.sum(2) - d_seg.sum(1) - gdg \
            + e_in[c] * torch.einsum("bin,bihn->bih", cq, t_c)
        dcum[:, -1] += gdg.sum(1) + extra[c]
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        grads["a"][c] = torch.where(ac[c] > 1e-20, dla / ac[c],
                                    torch.zeros((), device=dev))
        grads["x"][c] = dxdt * dtq[..., None]
        grads["dt"][c] = (dxdt * xq).sum(-1)

    def whole(ts, like):
        t = torch.stack(ts, dim=1)
        return t.reshape(b, nc * q, *t.shape[3:])[:, :s].to(like.dtype)

    return (whole(grads["x"], x), whole(grads["dt"], dt),
            whole(grads["a"], a_decay), whole(grads["b"], bmat),
            whole(grads["c"], cmat),
            None if init_state is None else grad.to(init_state.dtype))
