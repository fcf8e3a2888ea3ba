"""The MoE FFN and the MoE and VLM decoders of the port
(repro_torch.models.moe, repro_torch.models.transformer) against the
reference (repro.models), and the port's engine serving them against the
reference's engine.

Both sides run the same numpy-seeded inputs on the reference's weights,
upcast to f32 (jax 0.9 on the CPU cannot run a bf16 x bf16 -> f32 dot,
ROADMAP Queue C R1).  ``moe_ffn`` alone: the top-K experts equal, the
kept assignments and their gates equal, outputs and the aux loss within
rtol / atol 1e-5, at decode capacity (nothing drops) and prefill capacity
(tokens drop), for swiglu, gelu and squared-relu, with shared experts,
and with tied router probabilities.  The decoders (reduced olmoe-1b-7b,
deepseek-moe-16b, internvl2-76b with patches): forward logits and aux
loss, and ``Model.prefill`` -> ``Model.decode_step``, within 1e-4, and
the reference's own consistency check (tests/test_models_consistency.py)
on the port.  The engines (tests/torch_parity.py): greedy streams and
counters equal to the reference's, fused and orchestrated, swap and
recompute, chunked prefill under a token budget and four decode steps a
call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.layers import init_from_template as ref_init
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro.models.moe import moe_template as ref_moe_template
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.moe import (capacity, expert_group, moe_ffn,
                                    moe_route)
from torch_parity import PORT, REF, counters, engine

torch.set_num_threads(1)

TOL = 1e-5
ATOL = 1e-4
# (arch, overrides) of the FFN cases: swiglu (olmoe), shared experts and
# swiglu (deepseek), gelu and squared-relu, and eight experts, three a
# token
FFN_CASES = {
    "swiglu": ("olmoe-1b-7b", {}),
    "shared": ("deepseek-moe-16b", {}),
    "gelu": ("olmoe-1b-7b", {"activation": "gelu"}),
    "squared_relu": ("olmoe-1b-7b", {"activation": "squared_relu"}),
    "e8k3": ("olmoe-1b-7b", {"n_experts": 8, "experts_per_token": 3}),
}
MODELS = ["olmoe-1b-7b", "deepseek-moe-16b", "internvl2-76b"]
SERVED = ["olmoe-1b-7b", "internvl2-76b"]


def _ffn_pair(case, seed=0):
    """(ref cfg, port cfg, ref params, port params) of one FFN case: the
    reference's template, initialised by the reference and upcast."""
    arch, ov = FFN_CASES[case]
    rcfg = ref_get_config(arch, reduced=True).with_overrides(**ov)
    cfg = get_config(arch, reduced=True).with_overrides(**ov)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_init(ref_moe_template(rcfg),
                                 jax.random.PRNGKey(seed)))
    # a wider router than the init's: decisive, uneven routing
    tree["router"] = np.random.default_rng(seed).normal(
        0, 0.5, tree["router"].shape).astype(np.float32)
    return rcfg, cfg, tree, params_from_numpy(tree, "cpu")


def _ref_routing(tree, x, rcfg):
    """The reference's top-K indices of x (B, S, D), as moe_ffn computes
    them."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ jnp.asarray(tree["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(probs, rcfg.experts_per_token)[1])


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case, decode):
    rcfg, cfg, tree, params = _ffn_pair(case)
    if not decode:
        # a capacity of half the even share: every case drops tokens
        rcfg = rcfg.with_overrides(capacity_factor=0.5)
        cfg = cfg.with_overrides(capacity_factor=0.5)
    x = np.random.default_rng(3).normal(0, 1, (2, 24, cfg.d_model)) \
        .astype(np.float32)
    want, want_aux = ref_moe_ffn(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x), rcfg, decode=decode)
    got, aux = moe_ffn(params, torch.from_numpy(x), cfg, decode=decode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL,
                               atol=TOL)

    # the routing itself: the experts, their capacity rows and gates
    n, k = 2 * 24, cfg.experts_per_token
    c = capacity(cfg, n, decode=decode)
    _, row, w, _ = moe_route(params, torch.from_numpy(x).reshape(n, -1),
                               cfg, decode=decode)
    top_i = _ref_routing(tree, x, rcfg)
    np.testing.assert_array_equal((row // c).view(n, k).numpy(), top_i)
    kept = int((w > 0).sum())
    if decode:
        assert c == n * k and kept == n * k
    else:
        assert c < n * k and kept < n * k, "no token dropped"
        # every expert fills its capacity before dropping
        per_expert = np.bincount(top_i.reshape(-1), minlength=cfg.n_experts)
        assert kept == int(np.minimum(per_expert, c).sum())


def test_moe_ffn_ties_keep_the_lower_expert():
    """Experts with equal router columns tie in every token's
    probabilities: the port orders them as jax.lax.top_k does, lower
    index first."""
    rcfg, cfg, tree, params = _ffn_pair("e8k3")
    r = tree["router"]
    r[:, 5] = r[:, 2]
    r[:, 6] = r[:, 1]
    r[:, 7] = r[:, 1]
    params = params_from_numpy(tree, "cpu")
    x = np.random.default_rng(4).normal(0, 1, (1, 32, cfg.d_model)) \
        .astype(np.float32)
    n, k = 32, cfg.experts_per_token
    _, row, _, _ = moe_route(params, torch.from_numpy(x)[0], cfg,
                               decode=True)
    got = (row // (n * k)).view(n, k).numpy()
    want = _ref_routing(tree, x, rcfg)
    np.testing.assert_array_equal(got, want)
    # the draw really ties: some token takes two of a tied set
    tied = [{2, 5}, {1, 6, 7}]
    assert any(len(set(t) & s) >= 2 for t in want for s in tied)
    out, _ = moe_ffn(params, torch.from_numpy(x), cfg)
    ref, _ = ref_moe_ffn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                         rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_capacity_and_expert_group():
    cfg = get_config("olmoe-1b-7b")
    assert capacity(cfg, 8, decode=True) == 64
    assert capacity(cfg, 512, decode=False) == 80      # 4096 * 1.25 / 64
    assert capacity(cfg, 1, decode=False) == 1
    assert capacity(cfg.with_overrides(capacity_factor=64.0), 512,
                    decode=False) == 512 * 8
    # a shard of any expert-parallel width up to 8 holds whole groups
    assert expert_group(64) == 8 and expert_group(8) == 1
    assert expert_group(4) == 1 and expert_group(6) == 3


# ---------------------------------------------------------------- decoders

def _model_pair(arch, **ov):
    cfg = ref_get_config(arch, reduced=True).with_overrides(**ov)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(arch, reduced=True).with_overrides(**ov))
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port, \
        params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=MODELS)
def model_pair(request):
    return _model_pair(request.param)


def _batch(cfg, rng, b, s, n_patches=4):
    toks = rng.integers(3, cfg.vocab_size, (b, s))
    ref = {"tokens": jnp.asarray(toks, jnp.int32)}
    port = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        p = rng.normal(0, 0.02, (b, n_patches, cfg.d_model)) \
            .astype(np.float32)
        ref["patches"] = jnp.asarray(p)
        port["patches"] = torch.from_numpy(p)
    return ref, port


def test_template_and_bridge_carry_the_tree(model_pair):
    cfg, _, ref_params, port, params = model_pair
    assert jax.tree.map(lambda t: tuple(t.shape), params) \
        == jax.tree.map(lambda a: tuple(a.shape), ref_params)
    init = port.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), init) \
        == jax.tree.map(lambda a: tuple(a.shape), ref_params)
    if cfg.family == "moe":
        moe = init["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_in"].dtype == torch.bfloat16
        assert moe["w_in"].shape[:2] == (cfg.n_layers - cfg.first_k_dense,
                                         cfg.n_experts)
        assert ("dense_layers" in init) == (cfg.first_k_dense > 0)
        assert ("shared" in moe) == (cfg.n_shared_experts > 0)
        # the bridge keeps each leaf's dtype: an f32 router stays f32
        tree = jax.tree.map(np.asarray, ref_build_model(cfg).init(
            jax.random.PRNGKey(0)))
        bridged = params_from_numpy(tree, "cpu")["layers"]["moe"]
        assert bridged["router"].dtype == torch.float32
        assert bridged["w_out"].dtype == torch.bfloat16


def test_forward_logits_and_aux_match_reference(model_pair):
    """With patches for the VLM: prepended, positions over P + S."""
    cfg, ref, ref_params, port, params = model_pair
    rb, pb = _batch(cfg, np.random.default_rng(2), 2, 20)
    want, _, want_aux = ref.forward(ref_params, rb, remat=False)
    got, cache, aux = port.forward(params, pb, collect_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL,
                               rtol=TOL)
    if cfg.family == "moe":
        assert float(aux) > 0
    n = 20 + (4 if cfg.family == "vlm" else 0)
    assert got.shape[1] == n
    assert cache["k"].shape == (cfg.n_layers, 2, n, cfg.n_kv_heads,
                                cfg.head_dim)


def test_prefill_then_decode_matches_reference(model_pair):
    """Model.prefill -> 8 greedy Model.decode_step calls on both
    packages: logits within 1e-4, tokens identical."""
    cfg, ref, ref_params, port, params = model_pair
    b, s, steps, room = 2, 12, 8, 8
    rb, pb = _batch(cfg, np.random.default_rng(5), b, s)
    extra = 4 if cfg.family == "vlm" else 0
    lw, ref_cache = ref.prefill(ref_params, rb)
    lg, cache = port.prefill(params, pb)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=ATOL, rtol=0)
    pad = [(0, 0)] * 2 + [(0, steps + room)] + [(0, 0)] * 2
    ref_cache = {k: jnp.pad(v, pad) for k, v in ref_cache.items()}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, steps + room))
             for k, v in cache.items()}
    ref_tok = jnp.argmax(lw, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    for t in range(steps):
        cl = np.full((b,), s + extra + t, np.int32)
        lw, ref_cache = ref.decode_step(ref_params, ref_tok, ref_cache,
                                        jnp.asarray(cl))
        lg, cache = port.decode_step(params, tok, cache, torch.from_numpy(cl))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
        ref_tok = jnp.argmax(lw, -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        assert np.asarray(ref_tok).tolist() == tok.tolist()


@pytest.mark.parametrize("arch", MODELS)
def test_decode_matches_full_forward(arch):
    """tests/test_models_consistency.py on the port: with a capacity that
    drops nothing, prefill + one decode step equals the full forward's
    last position (the reference's bar)."""
    cfg = get_config(arch, reduced=True).with_overrides(capacity_factor=8.0)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(1))
    b, s = 2, 17
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s + 1)))
    bf, bp = {"tokens": toks}, {"tokens": toks[:, :s]}
    extra = 0
    if cfg.family == "vlm":
        pt = torch.from_numpy(rng.normal(0, 0.02, (b, 4, cfg.d_model))) \
            .bfloat16()
        bf["patches"] = bp["patches"] = pt
        extra = 4
    full, _, _ = m.forward(params, bf)
    want = full[:, -1, :].float()
    _, cache = m.prefill(params, bp)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
             for k, v in cache.items()}
    got, _ = m.decode_step(params, toks[:, s:s + 1], cache,
                           torch.full((b,), s + extra, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=5e-2, atol=2e-2)


# ------------------------------------------------------------------ engines

def _serve(pkg, arch, *, step_mode, pmode="swap", chunk=8, mtps=12,
           decode_steps=1, n=4):
    """tests/test_torch_engine.py's workload: 2 slots, a 48-token budget
    that preempts mid-decode, chunked prefill under a token budget."""
    core, serving, _, get_cfg, _ = pkg
    cfg = get_cfg(arch, reduced=True)
    o = core.OraclePredictor()
    for i in range(n):
        o.register(f"p{i}", core.LengthDistribution(np.array([6 + 3 * i]),
                                                    np.array([1.0])))
    eng = engine(pkg, arch, scheduler=core.Scheduler(
        policy=core.make_policy("sagesched"), predictor=o),
        n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
        preemption_mode=pmode, prefill_chunk=chunk, max_tokens_per_step=mtps,
        seed=0, step_mode=step_mode, decode_steps=decode_steps)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(n):
        toks = [int(t) for t in rng.integers(3, cfg.vocab_size,
                                             int(rng.integers(6, 19)))]
        reqs.append(serving.ServeRequest(
            f"r{i}", f"p{i}", toks, max_new_tokens=6 + 3 * i,
            temperature=0.0, eos_token=1, arrival=float(i) * 1e-3))
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=4000)
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    return eng, [r.output_tokens for r in reqs]


@pytest.mark.parametrize("pmode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
@pytest.mark.parametrize("arch", SERVED)
def test_engine_streams_and_counters_match_reference(arch, step_mode, pmode):
    er, want = _serve(REF, arch, step_mode=step_mode, pmode=pmode)
    ep, got = _serve(PORT, arch, step_mode=step_mode, pmode=pmode)
    assert got == want
    assert er.metrics.preemptions > 0 and er.metrics.prefill_chunks > 4
    if pmode == "swap":
        assert er.metrics.swap_outs > 0
    assert counters(ep) == counters(er)


@pytest.mark.parametrize("arch", SERVED)
def test_engine_multi_step_and_whole_prefill_match_reference(arch):
    """Four decode steps a fused call, and prefill in one chunk a
    request (no chunk size, no token budget)."""
    for kw in (dict(decode_steps=4), dict(chunk=None, mtps=None)):
        er, want = _serve(REF, arch, step_mode="fused", **kw)
        ep, got = _serve(PORT, arch, step_mode="fused", **kw)
        assert got == want, kw
        assert counters(ep) == counters(er), kw
