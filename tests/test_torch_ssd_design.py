"""The SSD scan as ``csrc/ssd_scan.cu`` computes it, checked on the CPU.

``ssd_passes_reference`` (``repro_torch/kernels/ssd_scan/ref.py``) repeats
the kernel's decomposition: C.B^T once per chunk, each chunk's own state,
the state from chunk to chunk, then y per 64-row tile, with every f32
factor rounded to the bf16 parts the tensor cores take (three for W, two
for B_j f_j and the carried state).  It is held to the JAX ``repro.models.ssm.ssd_chunked``,
to the Pallas kernel in interpret mode (as
``tests/test_torch_ssm.py::test_ssd_plain_vs_pallas_interpret_and_sequential``
runs it) and to the step-by-step ``ssd_sequential_reference``, at the
three (P, N) instances of the kernel, ragged S, with and without an
initial state, and with long memory (a in [0.99, 1]).

The tolerances are the card's (``chip_smoke.py`` BF16_TOL and
SSD_STATE_TOL, ``tests/test_torch_gpu.py``): y at rtol = atol = 2e-2 and
the final state at rtol = atol = 1e-3.  They hold with a wide margin
because C, B and x enter exactly (bf16 values, exact products in f32)
and each f32 factor enters as the sum of its bf16 parts, which carries it
to ~2^-16 of its size or better, far under 1e-3; the rest is f32
summation order.  A plain bf16 rounding of the same factors (one part
each) misses the state's bar, which a test below shows: that is what the
parts are for.  (W's third part is for the generate drives' bars on the
card, which are tighter than these: see csrc/ssd_scan.cu.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan_op
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd_scan.ref import (ssd_passes_reference,
                                              ssd_sequential_reference)

# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

Y_TOL = dict(rtol=2e-2, atol=2e-2)       # BF16_TOL on the card
STATE_TOL = dict(rtol=1e-3, atol=1e-3)   # SSD_STATE_TOL on the card
# (b, s, h, p, n, chunk): the kernel's three (P, N) instances at ragged
# S; q = 100 (S under the chunk) and the reduced configs' chunk 16 leave
# a 64-row tile partly past the chunk's rows
SHAPES = [(2, 300, 4, 64, 128, 256), (2, 333, 4, 64, 64, 128),
          (2, 45, 4, 32, 16, 16), (1, 100, 4, 64, 64, 256)]
SHORT, LONG = (0.5, 0.999), (0.99, 1.0)


def _inputs(seed, b, s, h, p, n, init=False, a_range=SHORT):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, (b, s, h, p)), rng.uniform(0.01, 1.0, (b, s, h)),
            rng.uniform(*a_range, (b, s, h)), rng.normal(0, 0.5, (b, s, n)),
            rng.normal(0, 0.5, (b, s, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    st = rng.normal(0, 1, (b, h, p, n)).astype(np.float32) if init else None
    return arrs, st


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("a_range", [SHORT, LONG], ids=["short", "long"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_passes_vs_jax_chunked_and_sequential(b, s, h, p, n, chunk, init,
                                              a_range):
    arrs, st = _inputs(s + n + init, b, s, h, p, n, init, a_range)
    st_t = None if st is None else torch.from_numpy(st)
    got_y, got_st = ssd_passes_reference(*_t(arrs), st_t, chunk=chunk)
    want_y, want_st = ref_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in arrs),
        None if st is None else jnp.asarray(st), chunk=chunk)
    seq_y, seq_st = ssd_sequential_reference(*_t(arrs), st_t)
    for y, state in ((torch.from_numpy(np.array(want_y)),
                      torch.from_numpy(np.array(want_st))),
                     (seq_y, seq_st)):
        torch.testing.assert_close(got_y, y, **Y_TOL)
        torch.testing.assert_close(got_st, state, **STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_passes_vs_pallas_interpret(b, s, h, p, n, chunk):
    arrs, _ = _inputs(7 * s + n, b, s, h, p, n)
    pallas = ssd_scan_op(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                         force_pallas=True)
    got_y, _ = ssd_passes_reference(*_t(arrs), chunk=chunk)
    torch.testing.assert_close(got_y, torch.from_numpy(np.array(pallas)),
                               **Y_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES[:3])
def test_bf16_rounding_alone_fails_the_state_bar(b, s, h, p, n, chunk):
    """The same passes with each f32 factor rounded to bf16 alone miss
    the state's 1e-3 at long memory, where the split passes it."""
    arrs, st = _inputs(11 + n, b, s, h, p, n, True, LONG)
    st_t = torch.from_numpy(st)
    _, want = ssd_sequential_reference(*_t(arrs), st_t)
    _, split = ssd_passes_reference(*_t(arrs), st_t, chunk=chunk)
    _, plain = ssd_passes_reference(*_t(arrs), st_t, chunk=chunk,
                                    w_parts=1, parts=1)
    torch.testing.assert_close(split, want, **STATE_TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(plain, want, **STATE_TOL)


@pytest.mark.parametrize("s_valid,s,h,p,n,chunk", [
    (23, 32, 4, 32, 16, 16),        # the reduced configs' instance
    (777, 1024, 2, 64, 128, 256),   # mamba2-2.7b's, as chip_smoke.py pads
])
def test_passes_pads_bit_unchanged(s_valid, s, h, p, n, chunk):
    """Rows past the true length as the model makes them (dt = 0, a = 1,
    real x, B and C) leave y and the final state bit-unchanged."""
    arrs, _ = _inputs(s_valid, 1, s, h, p, n)
    x, dt, a, bm, cm = _t(arrs)
    y0, s0 = ssd_passes_reference(x[:, :s_valid], dt[:, :s_valid],
                                  a[:, :s_valid], bm[:, :s_valid],
                                  cm[:, :s_valid], chunk=chunk)
    dt, a = dt.clone(), a.clone()
    dt[:, s_valid:], a[:, s_valid:] = 0.0, 1.0
    y1, s1 = ssd_passes_reference(x, dt, a, bm, cm, chunk=chunk)
    assert torch.equal(y0, y1[:, :s_valid]) and torch.equal(s0, s1)


def test_passes_row_independent_of_batch():
    """A row's y and final state are the same alone and inside a batch of
    4, bit for bit (each row runs the passes on its own)."""
    arrs, st = _inputs(5, 4, 300, 4, 64, 64, True, LONG)
    x, dt, a, bm, cm = _t(arrs)
    st = torch.from_numpy(st)
    y, fin = ssd_passes_reference(x, dt, a, bm, cm, st, chunk=256)
    y2, fin2 = ssd_passes_reference(x[2:3], dt[2:3], a[2:3], bm[2:3],
                                    cm[2:3], st[2:3], chunk=256)
    assert torch.equal(y[2:3], y2) and torch.equal(fin[2:3], fin2)
