"""The SSD scan's backward in the port: ``ssd_backward_reference`` (the
plain version of ``csrc/ssd_scan_bwd.cu``) and ``SSDScanFunction``, the
scan under autograd, on the CPU.

Every gradient (x, dt, a, B, C and the initial state) is held, within
1e-4 in relative norm and in f32, to autograd of the port's
``ssd_chunked_reference`` and to ``jax.grad`` of the reference's
sequential scans: ``repro/kernels/ssd_scan/ref.py::ssd_reference`` (a
zero initial state, y only) and the sequential oracle of
tests/test_torch_training.py (the initial and final states).  The
reference's chunked ``ssd_chunked`` is no oracle: its gradient is NaN
(ROADMAP Queue C R7).  Decays go down to 1e-6 against the JAX oracles;
below the 1e-20 clamp of log a, where the sequential scans have no clamp,
only against autograd of ``ssd_chunked_reference``.  Inputs come from a
numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_reference
from repro_torch.kernels.ssd_scan.ops import SSDScanFunction, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_backward_passes_reference,
                                              ssd_backward_reference,
                                              ssd_chunked_reference)
from test_torch_training import _sequential_ssd

# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

BAR = 1e-4
# (b, s, h, p, n, chunk): whole chunks, S not a multiple of the chunk, S
# under the chunk, and the reduced configs' (P, N) = (32, 16)
SHAPES = [(2, 48, 3, 8, 4, 16), (1, 37, 2, 8, 4, 16), (2, 11, 2, 8, 4, 16),
          (1, 40, 2, 32, 16, 16)]
# the decays' range: short memory, long memory, and down to 1e-6
DECAYS = {"short": (0.5, 0.999), "long": (0.99, 1.0), "1e-6": (1e-6, 1.0)}
NAMES = ("dx", "ddt", "da", "dB", "dC", "dinit")


def _inputs(shape, decay, init, seed=0):
    """f32 (x, dt, a, B, C, init or None, dy, dstate) from a numpy seed."""
    b, s, h, p, n, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, (b, s, h, p)), rng.uniform(0.01, 1.0, (b, s, h)),
            rng.uniform(*DECAYS[decay], (b, s, h)),
            rng.normal(0, 0.5, (b, s, n)), rng.normal(0, 0.5, (b, s, n)),
            rng.normal(0, 1, (b, h, p, n)) if init else None,
            rng.normal(0, 1, (b, s, h, p)), rng.normal(0, 1, (b, h, p, n))]
    return [None if a is None else a.astype(np.float32) for a in arrs]


def _t(arrs, grad=False):
    return [None if a is None else torch.from_numpy(a).requires_grad_(grad)
            for a in arrs]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _hold(got, want, label):
    assert len(got) == len(want)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, f"{label} {name}"
            continue
        g = g.detach() if isinstance(g, torch.Tensor) else g
        assert np.isfinite(np.asarray(g)).all(), f"{label} {name}"
        err = _rel(g, w)
        assert err <= BAR, f"{label} {name}: {err:.3e}"


def _autograd(ins, dy, dstate, chunk, fn=ssd_chunked_reference):
    """Autograd of ``fn`` (the plain chunked scan, or ``ssd_scan``, which
    takes SSDScanFunction) for <y, dy> + <final, dstate>."""
    ts = _t(ins, grad=True)
    y, final = fn(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dstate is not None:
        loss = loss + (final * torch.from_numpy(dstate)).sum()
    live = [t for t in ts if t is not None]
    grads = iter(torch.autograd.grad(loss, live))
    return [None if t is None else next(grads) for t in ts]


def _jax_sequential(ins, dy, dstate):
    """jax.grad of the sequential oracle with its initial and final state
    (zeros where there is no initial state)."""
    x, dt, a, bm, cm, init = ins
    b, s, h, p = x.shape
    init = np.zeros((b, h, p, bm.shape[-1]), np.float32) if init is None \
        else init

    def loss(*args):
        y, final = _sequential_ssd(*args)
        out = (y * dy).sum()
        return out if dstate is None else out + (final * dstate).sum()

    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm, init)))


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("init", [False, True], ids=["no_init", "init"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_autograd_of_the_chunked_scan(shape, init, decay):
    """ssd_backward_reference and SSDScanFunction (ssd_scan under
    autograd) against autograd of ssd_chunked_reference, with a final-state
    gradient."""
    *ins, dy, dstate = _inputs(shape, decay, init)
    chunk = shape[-1]
    want = _autograd(ins, dy, dstate, chunk)
    got = ssd_backward_reference(*_t(ins), torch.from_numpy(dy),
                                 torch.from_numpy(dstate), chunk=chunk)
    _hold(got, want, "ssd_backward_reference")
    _hold(_autograd(ins, dy, dstate, chunk, fn=ssd_scan), want,
          "SSDScanFunction")


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("init", [False, True], ids=["no_init", "init"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_jax_sequential_oracle(shape, init, decay):
    """Both against jax.grad of the reference's sequential scan with its
    initial and final state; dinit compared where there is one."""
    *ins, dy, dstate = _inputs(shape, decay, init, seed=1)
    chunk = shape[-1]
    want = list(_jax_sequential(ins, dy, dstate))
    if not init:
        want[5] = None
    got = ssd_backward_reference(*_t(ins), torch.from_numpy(dy),
                                 torch.from_numpy(dstate), chunk=chunk)
    _hold(got, want, "ssd_backward_reference")
    _hold(_autograd(ins, dy, dstate, chunk, fn=ssd_scan), want,
          "SSDScanFunction")


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("init", [False, True], ids=["no_init", "init"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_passes_reference_matches_plain_and_jax_oracle(shape, init, decay):
    """ssd_backward_passes_reference (the kernel's passes, every f32
    factor of a product in two bf16 parts: ~2^-17 relative a term, ~3e-6
    in relative norm) against ssd_backward_reference and against jax.grad
    of the reference's sequential scan, within BAR; ragged S and S under
    the chunk included."""
    *ins, dy, dstate = _inputs(shape, decay, init, seed=7)
    chunk = shape[-1]
    got = ssd_backward_passes_reference(*_t(ins), torch.from_numpy(dy),
                                        torch.from_numpy(dstate),
                                        chunk=chunk)
    exact = ssd_backward_reference(*_t(ins), torch.from_numpy(dy),
                                   torch.from_numpy(dstate), chunk=chunk)
    _hold(got, exact, "ssd_backward_passes_reference vs plain")
    want = list(_jax_sequential(ins, dy, dstate))
    if not init:
        want[5] = None
    _hold(got, want, "ssd_backward_passes_reference vs jax")


def test_passes_reference_padded_rows_get_zero_gradients():
    """The passes reference on rows padded as the engine pads them: dx,
    ddt, dB and dC exactly zero there, the valid rows within BAR of the
    unpadded call's."""
    shape = (2, 40, 2, 8, 4, 16)
    *ins, dy, dstate = _inputs(shape, "long", True, seed=8)
    s = 29
    padded = [t.copy() for t in ins[:5]] + [ins[5]]
    for i, t in enumerate(padded[:5]):
        t[:, s:] = 1.0 if i == 2 else 0.0
    dyp = dy.copy()
    dyp[:, s:] = 0.0
    got = ssd_backward_passes_reference(*_t(padded), torch.from_numpy(dyp),
                                        torch.from_numpy(dstate), chunk=16)
    for name, g in zip(NAMES[:5], got[:5]):
        if name != "da":
            assert torch.equal(g[:, s:], torch.zeros_like(g[:, s:])), name
    short = ssd_backward_reference(
        *_t([t[:, :s] for t in ins[:5]] + [ins[5]]),
        torch.from_numpy(dy[:, :s]), torch.from_numpy(dstate), chunk=16)
    for name, g, w in zip(NAMES, got, short):
        g = g[:, :s] if name != "dinit" else g
        assert _rel(g, w) <= BAR, name


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_jax_ssd_reference(shape, decay):
    """A zero initial state and y only: jax.grad of the reference's
    ssd_reference (repro/kernels/ssd_scan/ref.py), the Pallas kernel's
    oracle."""
    *ins, dy, _ = _inputs(shape, decay, False, seed=2)
    x, dt, a, bm, cm, _ = ins
    want = jax.grad(lambda *t: (ssd_reference(*t) * dy).sum(),
                    argnums=tuple(range(5)))(
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    chunk = shape[-1]
    got = ssd_backward_reference(*_t(ins), torch.from_numpy(dy), None,
                                 chunk=chunk)
    _hold(got, list(want) + [None], "ssd_backward_reference")
    _hold(_autograd(ins, dy, None, chunk, fn=ssd_scan), list(want) + [None],
          "SSDScanFunction")


@pytest.mark.parametrize("init", [False, True], ids=["no_init", "init"])
def test_decays_below_the_clamp_against_autograd(init):
    """Decays under 1e-20 (log a clamped, da 0 there): autograd of
    ssd_chunked_reference only."""
    shape = SHAPES[1]
    *ins, dy, dstate = _inputs(shape, "1e-6", init, seed=3)
    ins[2][0, ::5, 0] = 1e-25
    ins[2][0, 3, 1] = 0.0
    want = _autograd(ins, dy, dstate, shape[-1])
    got = ssd_backward_reference(*_t(ins), torch.from_numpy(dy),
                                 torch.from_numpy(dstate), chunk=shape[-1])
    _hold(got, want, "ssd_backward_reference")
    _hold(_autograd(ins, dy, dstate, shape[-1], fn=ssd_scan), want,
          "SSDScanFunction")
    assert float(got[2][0, 5, 0]) == 0.0 and float(got[2][0, 3, 1]) == 0.0


def test_padded_rows_get_zero_gradients():
    """Rows padded as the engine pads them (x, B, C = 0, dt = 0, a = 1),
    with no output gradient there: dx, ddt, dB and dC of those rows are
    exactly zero, and the valid rows' gradients are the unpadded call's."""
    shape = (2, 40, 2, 8, 4, 16)
    *ins, dy, dstate = _inputs(shape, "short", True, seed=4)
    s = 29
    padded = [t.copy() for t in ins[:5]] + [ins[5]]
    for i, t in enumerate(padded[:5]):
        t[:, s:] = 1.0 if i == 2 else 0.0
    dyp = dy.copy()
    dyp[:, s:] = 0.0
    got = ssd_backward_reference(*_t(padded), torch.from_numpy(dyp),
                                 torch.from_numpy(dstate), chunk=16)
    for name, g in zip(NAMES[:5], got[:5]):
        if name != "da":
            assert torch.equal(g[:, s:], torch.zeros_like(g[:, s:])), name
    short = ssd_backward_reference(
        *_t([t[:, :s] for t in ins[:5]] + [ins[5]]),
        torch.from_numpy(dy[:, :s]), torch.from_numpy(dstate), chunk=16)
    for name, g, w in zip(NAMES, got, short):
        g = g[:, :s] if name != "dinit" else g
        assert _rel(g, w) <= BAR, name


def test_none_final_state_gradient_counts_as_zeros():
    """Training discards the final state: autograd hands SSDScanFunction
    None for it, which gives the gradients of a zero dstate."""
    shape = SHAPES[0]
    *ins, dy, _ = _inputs(shape, "short", True, seed=5)
    got = _autograd(ins, dy, None, shape[-1], fn=ssd_scan)
    zeros = ssd_backward_reference(*_t(ins), torch.from_numpy(dy),
                                   torch.zeros(ins[5].shape),
                                   chunk=shape[-1])
    for name, g, w in zip(NAMES, got, zeros):
        assert torch.equal(g, w), name
    # only the state used: y's gradient None, counted as zeros too
    ts = _t(ins, grad=True)
    _, final = ssd_scan(*ts, chunk=shape[-1])
    grads = torch.autograd.grad(final.sum(), ts)
    want = ssd_backward_reference(*_t(ins), torch.zeros(dy.shape),
                                  torch.ones(ins[5].shape), chunk=shape[-1])
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name


def test_serving_path_unchanged_without_autograd():
    """Under torch.no_grad(), or with nothing requiring grad, ssd_scan runs
    the serving path: no SSDScanFunction node, and the same bits as the
    plain chunked scan; under autograd the forward's values are those
    bits too."""
    shape = SHAPES[1]
    *ins, _, _ = _inputs(shape, "short", True, seed=6)
    chunk = shape[-1]
    want = ssd_chunked_reference(*_t(ins), chunk=chunk)
    with torch.no_grad():
        got = ssd_scan(*_t(ins, grad=True), chunk=chunk)
    plain = ssd_scan(*_t(ins), chunk=chunk)
    graded = ssd_scan(*_t(ins, grad=True), chunk=chunk)
    for out in (got, plain):
        assert all(t.grad_fn is None for t in out)
    assert graded[0].grad_fn.next_functions[0][0].name() \
        == SSDScanFunction.__name__ + "Backward"
    for out in (got, plain, graded):
        for g, w in zip(out, want):
            assert torch.equal(g.detach(), w)
