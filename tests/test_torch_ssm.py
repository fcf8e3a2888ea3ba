"""Mamba2 SSD scan, Mamba2 block and the SSM / hybrid decoders of the port
(repro_torch) against the reference (repro) on the CPU.

Inputs come from numpy seeds.  Model weights are the reference's own,
upcast to f32 (jax 0.9 on the CPU cannot run a bf16 x bf16 -> f32 dot)
and carried into the port by ``params_from_numpy``.  Checked: the plain
scan versions against the JAX chunked scan, the Pallas kernel in
interpret mode and the sequential recurrence (atol / rtol 1e-4); the conv,
block and decode step (atol 1e-4); reduced mamba2-2.7b and zamba2-1.2b
prefill logits and state, and 16 greedy paged-decode tokens identical;
the port's padded prefill bit-identical to the unpadded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.ssd_scan.ops import ssd_scan_op
from repro.kernels.ssd_scan.ref import ssd_reference
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan.ops import SSD_SCAN_KERNEL, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_reference,
                                              ssd_sequential_reference)
from repro_torch.models import build_model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.bridge import params_from_numpy

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
ATOL = 1e-4
# the three shapes of tests/test_kernels.py's SSD kernel test
SHAPES = [(2, 128, 4, 32, 16, 32), (1, 200, 8, 64, 32, 64),
          (2, 64, 2, 16, 8, 64)]


def _ssd_inputs(seed, b, s, h, p, n, init=False, a_range=(0.5, 0.999)):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, (b, s, h, p)), rng.uniform(0.01, 1.0, (b, s, h)),
            rng.uniform(*a_range, (b, s, h)), rng.normal(0, 0.5, (b, s, n)),
            rng.normal(0, 0.5, (b, s, n))]
    if init:
        arrs.append(rng.normal(0, 1, (b, h, p, n)))
    return [a.astype(np.float32) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------------------ the SSD scan

@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_plain_vs_jax_chunked(b, s, h, p, n, chunk, init):
    arrs = _ssd_inputs(s + h, b, s, h, p, n, init)
    x, dt, a, bm, cm = arrs[:5]
    st = arrs[5] if init else None
    want_y, want_st = ref_ssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
        jnp.asarray(cm), None if st is None else jnp.asarray(st), chunk=chunk)
    got_y, got_st = ssd_chunked_reference(
        *_t([x, dt, a, bm, cm]), None if st is None else torch.from_numpy(st),
        chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)
    # the op (padding + dispatch) gives the plain version's result
    op_y, op_st = ssd_scan(*_t([x, dt, a, bm, cm]),
                           None if st is None else torch.from_numpy(st),
                           chunk=chunk)
    assert torch.equal(op_y, got_y) and torch.equal(op_st, got_st)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_plain_vs_pallas_interpret_and_sequential(b, s, h, p, n, chunk):
    x, dt, a, bm, cm = _ssd_inputs(7 * s + n, b, s, h, p, n)
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    pallas = np.asarray(ssd_scan_op(*j, chunk=chunk, force_pallas=True))
    oracle = np.asarray(ssd_reference(*j))
    got_y, got_st = ssd_chunked_reference(*_t([x, dt, a, bm, cm]),
                                          chunk=chunk)
    seq_y, seq_st = ssd_sequential_reference(*_t([x, dt, a, bm, cm]))
    np.testing.assert_allclose(got_y.numpy(), pallas, **TOL)
    np.testing.assert_allclose(got_y.numpy(), oracle, **TOL)
    np.testing.assert_allclose(seq_y.numpy(), oracle, **TOL)
    np.testing.assert_allclose(got_st.numpy(), seq_st.numpy(), **TOL)


def test_ssd_sequential_with_initial_state():
    b, s, h, p, n = 1, 200, 8, 64, 32
    x, dt, a, bm, cm, st = _ssd_inputs(3, b, s, h, p, n, init=True)
    got_y, got_st = ssd_chunked_reference(*_t([x, dt, a, bm, cm]),
                                          torch.from_numpy(st), chunk=64)
    seq_y, seq_st = ssd_sequential_reference(*_t([x, dt, a, bm, cm]),
                                             torch.from_numpy(st))
    torch.testing.assert_close(got_y, seq_y, **TOL)
    torch.testing.assert_close(got_st, seq_st, **TOL)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_long_memory_vs_jax_and_sequential(init):
    """Decays drawn near 1 (a in [0.99, 1]), as trained Mamba2 dt gives:
    the initial state and the chunk-to-chunk carry reach the final state
    and most rows of y, and exp(cum_i - cum_j) spans whole chunks."""
    b, s, h, p, n, chunk = 1, 300, 4, 16, 8, 64
    arrs = _ssd_inputs(17, b, s, h, p, n, init, a_range=(0.99, 1.0))
    x, dt, a, bm, cm = arrs[:5]
    st = torch.from_numpy(arrs[5]) if init else None
    want_y, want_st = ref_ssm.ssd_chunked(
        *(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
        None if st is None else jnp.asarray(arrs[5]), chunk=chunk)
    got_y, got_st = ssd_chunked_reference(*_t([x, dt, a, bm, cm]), st,
                                          chunk=chunk)
    seq_y, seq_st = ssd_sequential_reference(*_t([x, dt, a, bm, cm]), st)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)
    torch.testing.assert_close(got_y, seq_y, **TOL)
    torch.testing.assert_close(got_st, seq_st, **TOL)
    if init:
        # the initial state still carries weight at the end of the scan
        zero_y, zero_st = ssd_chunked_reference(*_t([x, dt, a, bm, cm]),
                                                chunk=chunk)
        assert float((got_st - zero_st).abs().max()) > 1e-2
        assert float((got_y[:, -1] - zero_y[:, -1]).abs().max()) > 1e-2


def test_ssd_pads_carry_the_state_bit_for_bit():
    """dt = 0, a = 1 rows past the true length leave y and the final
    state of the plain path unchanged, bit for bit, when the chunking
    is the same (S = 23 and S = 32 at chunk 16)."""
    x, dt, a, bm, cm = _t(_ssd_inputs(5, 1, 32, 4, 8, 4))
    dt2, a2 = dt.clone(), a.clone()
    dt2[:, 23:], a2[:, 23:] = 0.0, 1.0
    y0, s0 = ssd_scan(x[:, :23], dt[:, :23], a[:, :23], bm[:, :23],
                      cm[:, :23], chunk=16)
    y1, s1 = ssd_scan(x, dt2, a2, bm, cm, chunk=16)
    assert torch.equal(y0, y1[:, :23]) and torch.equal(s0, s1)


def test_ssd_op_refuses_other_devices_and_launches_nothing_on_cpu():
    meta = torch.device("meta")
    x = torch.empty(1, 64, 4, 64, dtype=torch.bfloat16, device=meta)
    d = torch.empty(1, 64, 4, device=meta)
    bm = torch.empty(1, 64, 64, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan(x, d, d, bm, bm)
    before = SSD_SCAN_KERNEL.launches
    ssd_scan(*_t(_ssd_inputs(1, 1, 40, 2, 16, 8)), chunk=16)
    assert SSD_SCAN_KERNEL.launches == before


# ------------------------------------------------------ block-level pieces

@pytest.fixture(scope="module")
def ssm_layer():
    """Layer 0 of reduced mamba2-2.7b: (cfg, ref params, port params)."""
    cfg = ref_get_config("mamba2-2.7b", reduced=True)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_build_model(cfg).init(jax.random.PRNGKey(3)))
    lp = jax.tree.map(lambda a: a[0], tree["layers"]["ssm"])
    rng = np.random.default_rng(4)
    # non-trivial dt bias and skip, so a wiring fault cannot hide
    lp["dt_bias"] = rng.normal(0, 0.5, lp["dt_bias"].shape).astype(np.float32)
    lp["d_skip"] = rng.normal(1, 0.5, lp["d_skip"].shape).astype(np.float32)
    return (cfg, jax.tree.map(jnp.asarray, lp), params_from_numpy(lp, "cpu"))


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_with_lengths(ssm_layer, with_tail):
    cfg, ref_p, port_p = ssm_layer
    rng = np.random.default_rng(5)
    di, k = cfg.d_inner, cfg.conv_kernel
    x = rng.normal(0, 1, (3, 20, di)).astype(np.float32)
    tail = rng.normal(0, 1, (3, k - 1, di)).astype(np.float32) \
        if with_tail else None
    lengths = np.array([20, 7, 1], np.int32)
    for ln in (None, lengths):
        want, want_tail = ref_ssm._causal_conv(
            jnp.asarray(x), ref_p["conv_w"],
            None if tail is None else jnp.asarray(tail),
            lengths=None if ln is None else jnp.asarray(ln))
        got, got_tail = port_ssm._causal_conv(
            torch.from_numpy(x), port_p["conv_w"],
            None if tail is None else torch.from_numpy(tail),
            lengths=None if ln is None else torch.from_numpy(ln))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got_tail.numpy(), np.asarray(want_tail),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block(ssm_layer, with_state):
    cfg, ref_p, port_p = ssm_layer
    rng = np.random.default_rng(6)
    u = rng.normal(0, 1, (2, 37, cfg.d_model)).astype(np.float32)
    lengths = np.array([37, 29], np.int32)
    state = None
    if with_state:
        shapes = port_ssm.ssm_state_shape(cfg, 2)
        state = {k: rng.normal(0, 1, v).astype(np.float32)
                 for k, v in shapes.items()}
    want, want_st = ref_ssm.mamba2_block(
        ref_p, jnp.asarray(u), cfg,
        None if state is None else jax.tree.map(jnp.asarray, state),
        lengths=jnp.asarray(lengths))
    got, got_st = port_ssm.mamba2_block(
        port_p, torch.from_numpy(u), cfg,
        None if state is None else {k: torch.from_numpy(v)
                                    for k, v in state.items()},
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for name in ("ssd", "conv"):
        np.testing.assert_allclose(got_st[name].numpy(),
                                   np.asarray(want_st[name]), atol=ATOL,
                                   rtol=0)


def test_mamba2_decode_step_and_frozen_rows(ssm_layer):
    cfg, ref_p, port_p = ssm_layer
    rng = np.random.default_rng(8)
    u = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    state = {k: rng.normal(0, 1, v).astype(np.float32)
             for k, v in port_ssm.ssm_state_shape(cfg, 3).items()}
    want, want_st = ref_ssm.mamba2_decode_step(
        ref_p, jnp.asarray(u), cfg, jax.tree.map(jnp.asarray, state))
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    got, got_st = port_ssm.mamba2_decode_step(port_p, torch.from_numpy(u),
                                              cfg, tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for name in ("ssd", "conv"):
        np.testing.assert_allclose(got_st[name].numpy(),
                                   np.asarray(want_st[name]), atol=ATOL,
                                   rtol=0)
    # an inactive row keeps every bit of its state; active rows are the
    # unmasked step's, bit for bit
    active = torch.tensor([True, False, True])
    _, frozen = port_ssm.mamba2_decode_step(port_p, torch.from_numpy(u),
                                            cfg, tstate, active=active)
    for name in ("ssd", "conv"):
        assert torch.equal(frozen[name][1], tstate[name][1])
        assert torch.equal(frozen[name][active], got_st[name][active])


# ------------------------------------------------------------ whole models

def _pair(arch):
    cfg = ref_get_config(arch, reduced=True)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(arch, reduced=True))
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port, \
        params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def test_template_and_init(pair):
    cfg, ref, ref_params, port, params = pair
    assert jax.tree.map(lambda t: tuple(t.shape), params) \
        == jax.tree.map(lambda a: tuple(a.shape), ref_params)
    p = port.init(torch.Generator().manual_seed(0))
    a_log = p["layers"]["ssm"]["a_log"]
    assert a_log.dtype == torch.float32
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0)
    assert float(a_log.std()) > 0.1                     # log U[1, 16]
    assert p["layers"]["ssm"]["conv_w"].dtype == torch.float32
    assert p["layers"]["ssm"]["in_proj_x"].dtype == torch.bfloat16
    if cfg.family == "hybrid":
        assert p["shared_attn"]["attn"]["wq"].dim() == 2    # one shared block


def test_prefill_logits_and_state(pair):
    cfg, ref, ref_params, port, params = pair
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, (2, 23))
    want, wc, _ = ref.forward(ref_params, {"tokens": jnp.asarray(tokens)},
                              collect_cache=True)
    got, gc, _ = port.forward(params, {"tokens": torch.from_numpy(tokens)},
                              collect_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for name in ("ssd", "conv"):
        np.testing.assert_allclose(gc["ssm"][name].numpy(),
                                   np.asarray(wc["ssm"][name]), atol=ATOL,
                                   rtol=0)
    assert set(gc) == set(wc)
    if "k" in wc:
        for name in ("k", "v"):
            assert gc[name].shape == wc[name].shape
            np.testing.assert_allclose(gc[name].numpy(),
                                       np.asarray(wc[name]), atol=ATOL,
                                       rtol=0)


def test_paged_cache_layout(pair):
    cfg, ref, _, port, _ = pair
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        ref.paged_cache_shapes(40, 8, 3))
    got = port.paged_cache_shapes(40, 8, 3)
    got = jax.tree.map(lambda leaf: (tuple(leaf[0]),
                                     str(leaf[1]).removeprefix("torch.")),
                       got, is_leaf=lambda x: isinstance(x, tuple))
    assert got == want
    cache = port.init_paged_cache(40, 8, 3, device="cpu")
    assert cache["ssm"]["ssd"].shape == want["ssm"]["ssd"][0]
    assert cache["ssm"]["conv"].dtype == torch.bfloat16
    # the engine holds the conv tail in its compute dtype
    f32 = port.init_paged_cache(40, 8, 3, device="cpu",
                                conv_dtype=torch.float32)
    assert f32["ssm"]["conv"].dtype == torch.float32
    assert f32["ssm"]["ssd"].dtype == torch.float32


def test_greedy_tokens_identical_16_steps(pair):
    """Prefill two prompts, then 16 greedy paged-decode steps on both
    sides from the prefilled state (and, for the hybrid, a random KV pool
    behind block tables)."""
    cfg, ref, ref_params, port, params = pair
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, cfg.vocab_size, (2, 12))
    _, wc, _ = ref.forward(ref_params, {"tokens": jnp.asarray(tokens)},
                           collect_cache=True)
    ssm = {k: np.asarray(v) for k, v in wc["ssm"].items()}
    ref_cache = {"ssm": {k: jnp.asarray(v) for k, v in ssm.items()}}
    cache = {"ssm": {k: torch.from_numpy(v.copy()) for k, v in ssm.items()}}
    page, n_pages, p_max = 8, 40, 8
    tables = np.stack([rng.permutation(np.arange(1, n_pages))[:p_max]
                       for _ in range(2)]).astype(np.int32)
    cl = np.array([12, 12], np.int32)
    if cfg.family == "hybrid":
        g = len(range(0, cfg.n_layers, cfg.hybrid_attn_every))
        shape = (g, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
        for name in ("k", "v"):
            pool = torch.from_numpy(rng.normal(0, 1, shape).astype(
                np.float32)).bfloat16()
            cache[name] = pool
            ref_cache[name] = jnp.asarray(pool.float().numpy(), jnp.bfloat16)
    tok = tokens[:, -1:].astype(np.int32)
    ref_tok, port_tok = jnp.asarray(tok), torch.from_numpy(tok)
    ref_cl, port_cl = jnp.asarray(cl), torch.from_numpy(cl)
    jt, pt = jnp.asarray(tables), torch.from_numpy(tables)
    want, got = [], []
    for step in range(16):
        lw, ref_cache = ref.decode_step_paged(ref_params, ref_tok, ref_cache,
                                              ref_cl, jt, page_size=page)
        lg, cache = port.decode_step_paged(params, port_tok, cache, port_cl,
                                           pt, page_size=page)
        if step == 0:
            np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=ATOL,
                                       rtol=0)
        ref_tok = jnp.argmax(lw, axis=-1).astype(jnp.int32)[:, None]
        port_tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        want.append(np.asarray(ref_tok)[:, 0].tolist())
        got.append(port_tok[:, 0].tolist())
        ref_cl, port_cl = ref_cl + 1, port_cl + 1
    assert got == want
    np.testing.assert_allclose(cache["ssm"]["ssd"].numpy(),
                               np.asarray(ref_cache["ssm"]["ssd"]),
                               atol=ATOL, rtol=0)


def test_padded_prefill_bit_identical_to_unpadded(pair):
    """The port's counterpart of tests/test_decode_hot_loop.py's padded
    prefill test: dt = 0 at the pads makes the pow2-padded prefill's
    state, conv tail and (hybrid) valid-position KV equal the unpadded
    prefill's, bit for bit, on the plain path."""
    cfg, _, _, port, params = pair
    s = 23
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, s))
    _, want = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    for spad in (32, 64):
        tp = np.zeros((1, spad), np.int64)
        tp[0, :s] = toks
        _, got = port.prefill(params, {"tokens": torch.from_numpy(tp),
                                       "lengths": torch.tensor([s])})
        for name in ("ssd", "conv"):
            assert torch.equal(want["ssm"][name], got["ssm"][name]), name
        if "k" in want:
            assert torch.equal(want["k"], got["k"][:, :, :s])
            assert torch.equal(want["v"], got["v"][:, :, :s])
