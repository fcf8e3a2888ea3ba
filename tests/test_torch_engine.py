"""Serving engine of the port (repro_torch.serving) against the reference
(repro.serving), and the port's own invariants.

The same requests, scheduler and weights (the reference's, upcast to f32
on both sides) go through both engines: token streams and the preemption /
swap counters must be identical, in both step modes and both preemption
modes, for the dense llama3.2-1b and the recurrent mamba2-2.7b (SSM) and
zamba2-1.2b (hybrid), greedy and at the paper's temperature 0.6 (the fused
step draws the reference's threefry categorical, ``kernels.categorical``;
the orchestrated step samples on the host as the reference does).  Inside
the port: fused == orchestrated, swap == recompute, multi-step ==
single-step, and for temperature > 0 the fused path's draws are invariant
to preemption mode and slot.

The reference's fused step cannot run the recurrent families with f32
weights as it stands: its decode returns the conv tail in the compute
dtype (f32), which its bf16 conv cache cannot carry through the fused
loop.  The tests start the reference's conv cache in f32, the dtype its
orchestrated step leaves there after one call and the one the port holds
it in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serving as ref_serving
import repro_torch.core as port_core
import repro_torch.serving as port_serving
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.kernels.categorical import categorical, prng_key
from repro_torch.kernels.categorical.ref import fold_in, gumbel, lane_keys

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "llama3.2-1b"
RECURRENT = ["mamba2-2.7b", "zamba2-1.2b"]
COUNTERS = ("preemptions", "swap_outs", "swap_ins", "forced_evictions",
            "grow_failures", "prefills", "prefill_chunks", "prefill_tokens",
            "decode_tokens", "completed")


def _weights(arch):
    cfg = ref_get_config(arch, reduced=True)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent(request):
    return (request.param,) + _weights(request.param)


def _f32_conv_cache(serving, eng):
    """Start the reference's conv cache in f32 (see the module note)."""
    if serving is ref_serving and "ssm" in eng._cache:
        eng._cache["ssm"]["conv"] = eng._cache["ssm"]["conv"].astype(
            jnp.float32)


def _requests(serving, vocab, n, temperature, order=None):
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(n):
        toks = [int(t) for t in rng.integers(3, vocab,
                                             int(rng.integers(6, 19)))]
        reqs.append(serving.ServeRequest(
            f"r{i}", f"p{i}", toks, max_new_tokens=6 + 3 * i,
            temperature=temperature, eos_token=1, arrival=float(i) * 1e-3))
    if order is not None:
        reqs = [reqs[i] for i in order]
    return reqs


def _run(pkg, params, *, step_mode, preemption_mode="swap", n=4,
         n_slots=2, cap=48, chunk=8, mtps=12, decode_steps=1,
         temperature=0.0, order=None, arch=ARCH):
    """Reduced ``arch`` (llama3.2-1b by default), an oracle predictor, a
    KV budget small enough to force preemption, chunked prefill mixed with
    decode (the recurrent families prefill whole)."""
    core, serving, get_cfg, build = pkg
    cfg = get_cfg(arch, reduced=True)
    o = core.OraclePredictor()
    for i in range(n):
        o.register(f"p{i}", core.LengthDistribution(np.array([6 + 3 * i]),
                                                    np.array([1.0])))
    kw = {"device": "cpu"} if serving is port_serving else {}
    eng = serving.ServingEngine(
        model=build(cfg),
        scheduler=core.Scheduler(policy=core.make_policy("sagesched"),
                                 predictor=o),
        n_slots=n_slots, max_seq_len=96, capacity_tokens=cap, block_size=8,
        preemption_mode=preemption_mode, prefill_chunk=chunk,
        max_tokens_per_step=mtps, seed=0, step_mode=step_mode,
        decode_steps=decode_steps, params=params, **kw)
    _f32_conv_cache(serving, eng)
    reqs = _requests(serving, cfg.vocab_size, n, temperature, order)
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=4000)
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    streams = {r.request_id: r.output_tokens for r in reqs}
    return eng, [streams[f"r{i}"] for i in range(n)]


REF = (ref_core, ref_serving, ref_get_config, ref_build_model)
PORT = (port_core, port_serving, get_config, build_model)


# the paper's default sampling temperature (repro/serving/request.py:27)
PAPER_TEMPERATURE = 0.6


def _hold_to_reference(ref_params, params, **kw):
    """Both engines on one workload: streams and counters equal, and the
    scheduler preempted (swapped, in swap mode, for the recurrent
    families)."""
    er, want = _run(REF, ref_params, **kw)
    ep, got = _run(PORT, params, **kw)
    assert got == want
    assert er.metrics.preemptions > 0
    for name in COUNTERS:
        assert getattr(ep.metrics, name) == getattr(er.metrics, name), name
    return er


@pytest.mark.parametrize("preemption_mode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_streams_and_counters_match_reference(weights, step_mode,
                                              preemption_mode):
    _hold_to_reference(*weights, step_mode=step_mode,
                       preemption_mode=preemption_mode)


@pytest.mark.parametrize("preemption_mode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_sampled_streams_and_counters_match_reference(weights, step_mode,
                                                      preemption_mode):
    """At the paper's temperature: the fused step's threefry draws and the
    orchestrated step's host draws give the reference's streams."""
    _hold_to_reference(*weights, step_mode=step_mode,
                       preemption_mode=preemption_mode,
                       temperature=PAPER_TEMPERATURE)


def _recurrent_kw(arch, step_mode, preemption_mode):
    return dict(step_mode=step_mode, preemption_mode=preemption_mode,
                arch=arch, chunk=None, mtps=None)


@pytest.mark.parametrize("preemption_mode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_recurrent_streams_and_counters_match_reference(
        recurrent, step_mode, preemption_mode):
    """SSM and hybrid: atomic padded prefill, slot-positional fused lanes
    with frozen inactive state, the recurrent state in the swap payload."""
    arch, ref_params, params = recurrent
    er = _hold_to_reference(ref_params, params,
                            **_recurrent_kw(arch, step_mode, preemption_mode))
    if preemption_mode == "swap":
        assert er.metrics.swap_outs > 0


@pytest.mark.parametrize("preemption_mode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_recurrent_sampled_streams_and_counters_match_reference(
        recurrent, step_mode, preemption_mode):
    """The recurrent families at the paper's temperature."""
    arch, ref_params, params = recurrent
    _hold_to_reference(ref_params, params,
                       temperature=PAPER_TEMPERATURE,
                       **_recurrent_kw(arch, step_mode, preemption_mode))


def test_recurrent_swap_and_recompute_mirror_reference(recurrent):
    """tests/test_paged_serving.py's swap-vs-recompute run (one slot, a
    32-token budget), with the long request admitted alone and two short
    ones arriving three steps later, so that SageSched preempts it.  The
    double feed of ROADMAP Queue C R3 makes the two modes absorb
    different tokens twice (swap: the prompt's last token; recompute: the
    last generated token), so the reference's swap and recompute streams
    need not agree: the port gives the reference's stream and counters in
    each mode, and agrees or differs where the reference does."""
    arch, ref_params, params = recurrent
    new_tokens = (20, 6, 9)

    def run(pkg, p, mode):
        core, serving, get_cfg, build = pkg
        cfg = get_cfg(arch, reduced=True)
        o = core.OraclePredictor()
        for i, m in enumerate(new_tokens):
            o.register(f"p{i}", core.LengthDistribution(np.array([m]),
                                                        np.array([1.0])))
        kw = {"device": "cpu"} if serving is port_serving else {}
        eng = serving.ServingEngine(
            model=build(cfg),
            scheduler=core.Scheduler(policy=core.make_policy("sagesched"),
                                     predictor=o),
            n_slots=1, max_seq_len=64, capacity_tokens=32, block_size=8,
            preemption_mode=mode, seed=0, params=p, **kw)
        _f32_conv_cache(serving, eng)
        rng = np.random.default_rng(9)
        reqs = []
        for i, m in enumerate(new_tokens):
            toks = [int(t) for t in rng.integers(3, cfg.vocab_size, 7)]
            reqs.append(serving.ServeRequest(
                f"s{i}", f"p{i}", toks, max_new_tokens=m,
                temperature=0.0, eos_token=1, arrival=float(i) * 1e-3))
        eng.submit(reqs[0])
        for _ in range(3):
            eng.step()
        eng.submit_batch(reqs[1:])
        eng.run_until_done(max_steps=3000)
        assert all(r.state == serving.RequestState.FINISHED for r in reqs)
        return eng, [r.output_tokens for r in reqs]

    out = {}
    for mode in ("swap", "recompute"):
        er, want = run(REF, ref_params, mode)
        ep, got = run(PORT, params, mode)
        assert got == want, mode
        assert er.metrics.preemptions > 0, mode
        for name in COUNTERS:
            assert getattr(ep.metrics, name) == getattr(er.metrics, name), \
                (mode, name)
        out[mode] = (ep, got, want)
    es, swap, ref_swap = out["swap"]
    er_, recompute, ref_recompute = out["recompute"]
    assert (swap == recompute) == (ref_swap == ref_recompute)
    assert es.metrics.swap_outs > 0 and er_.metrics.swap_outs == 0
    assert es.metrics.prefills == len(new_tokens)
    assert er_.metrics.prefills == len(new_tokens) + er_.metrics.preemptions


def test_recurrent_first_decode_mirrors_reference_double_feed(recurrent):
    """Pins ROADMAP Queue C R3.  After the atomic prefill of the whole
    context the engine rewinds one position and decodes ctx[-1] again, so
    an SSM state absorbs the last context token twice.  The port keeps the
    reference's behaviour: its first decode logits equal the reference's,
    and both differ from the last-position logits of a full forward."""
    arch, ref_params, params = recurrent
    logits = {}
    for pkg, p in ((REF, ref_params), (PORT, params)):
        core, serving, get_cfg, build = pkg
        cfg = get_cfg(arch, reduced=True)
        kw = {"device": "cpu"} if serving is port_serving else {}
        eng = serving.ServingEngine(
            model=build(cfg), scheduler=core.Scheduler(policy="fcfs"),
            n_slots=2, max_seq_len=64, step_mode="orchestrated", seed=0,
            params=p, **kw)
        _f32_conv_cache(serving, eng)
        seen = []
        sample = eng._sample_batch

        def record(rows, slots, temps, sample=sample, seen=seen):
            seen.append(np.asarray(rows, np.float32)[slots].copy())
            return sample(rows, slots, temps)

        eng._sample_batch = record
        toks = [int(t) for t in np.random.default_rng(11).integers(
            3, cfg.vocab_size, 20)]
        eng.submit(serving.ServeRequest("a", "p", toks, max_new_tokens=2,
                                        temperature=0.0, eos_token=-1))
        eng.step()
        logits[serving is port_serving] = seen[0][0]
    np.testing.assert_allclose(logits[True], logits[False], atol=1e-4,
                               rtol=0)
    tokens = np.asarray([toks])
    full, _, _ = ref_build_model(ref_get_config(arch, reduced=True)).forward(
        ref_params, {"tokens": jnp.asarray(tokens)})
    assert np.abs(logits[True] - np.asarray(full)[0, -1]).max() > 1e-3


def test_fused_equals_orchestrated_and_multi_step(weights):
    _, params = weights
    _, want = _run(PORT, params, step_mode="orchestrated")
    e1, got = _run(PORT, params, step_mode="fused")
    e4, got4 = _run(PORT, params, step_mode="fused", decode_steps=4)
    assert got == want and got4 == want
    assert e4.metrics.fused_steps < e1.metrics.fused_steps
    assert e4.metrics.decode_tokens == e1.metrics.decode_tokens


def test_swap_equals_recompute(weights):
    _, params = weights
    es, a = _run(PORT, params, step_mode="fused")
    er, b = _run(PORT, params, step_mode="fused",
                 preemption_mode="recompute")
    assert a == b
    assert es.metrics.swap_outs > 0 and er.metrics.swap_outs == 0
    assert er.metrics.prefills > es.metrics.prefills   # re-prefilled


def test_sampled_streams_swap_recompute_and_slot_invariant(weights):
    """temperature > 0 on the fused path: draws keyed by (engine seed,
    request seed, position) survive the preemption mode and a different
    submission order (other slots, other schedule)."""
    _, params = weights
    _, a = _run(PORT, params, step_mode="fused", temperature=0.8)
    _, b = _run(PORT, params, step_mode="fused", temperature=0.8,
                preemption_mode="recompute")
    _, c = _run(PORT, params, step_mode="fused", temperature=0.8,
                order=[3, 2, 1, 0], n_slots=3, cap=96)
    _, greedy = _run(PORT, params, step_mode="fused")
    assert a == b == c
    assert a != greedy                 # the noise is really drawn


def test_gumbel_noise_is_a_pure_function_of_its_keys():
    """The fused step's noise (the reference's threefry keys, folded with
    the request seed and the position): a lane's draw does not depend on
    the other lanes, the engine seed moves it, and it is a standard
    Gumbel."""
    seeds = torch.tensor([5, 2**32 - 1, 12345], dtype=torch.int64)
    pos = torch.tensor([0, 7, 7], dtype=torch.int64)
    keys = lane_keys(prng_key(0), seeds, pos)
    a = gumbel(keys, 1000)
    assert a.shape == (3, 1000) and torch.isfinite(a).all()
    assert torch.equal(a[1:2], gumbel(lane_keys(prng_key(0), seeds[1:2],
                                                pos[1:2]), 1000))
    assert not torch.equal(a, gumbel(lane_keys(prng_key(1), seeds, pos),
                                     1000))
    assert torch.equal(keys, fold_in(fold_in(prng_key(0), seeds), pos))
    # a standard Gumbel: mean = Euler-Mascheroni constant, var = pi^2 / 6
    assert abs(float(a.mean()) - 0.5772) < 0.1
    assert abs(float(a.var()) - 1.6449) < 0.3
    # the op's sampled pick is the argmax of logits / t + this noise
    logits = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (3, 1000)).astype(np.float32))
    t = torch.tensor([0.6, 0.6, 1.0])
    _, tok = categorical(logits, t, torch.zeros(3, dtype=torch.bool),
                         prng_key(0), seeds, pos)
    assert torch.equal(tok, torch.argmax(logits / t[:, None] + a, dim=-1))


def test_unported_options_refuse():
    """tp > 1 for the recurrent families (SSM and hybrid), refused until
    ROADMAP Queue A 16, now serves: each family at tp 2 on CPU shards (the
    hybrid with the memory preflight) finishes its requests with the plan
    in place (the matrix against the reference is
    tests/test_torch_sharded.py's)."""
    for arch, kw in (("mamba2-2.7b", {"tp": 2}),
                     ("zamba2-1.2b", {"tp": 2, "device_memory_gb": 1.0})):
        cfg = get_config(arch, reduced=True)
        eng = port_serving.ServingEngine(
            model=build_model(cfg),
            scheduler=port_core.Scheduler(policy="sagesched"),
            n_slots=2, max_seq_len=96, device="cpu", **kw)
        reqs = _requests(port_serving, cfg.vocab_size, 2, 0.0)
        eng.submit_batch(reqs)
        eng.run_until_done(max_steps=2000)
        assert all(r.state == port_serving.RequestState.FINISHED
                   for r in reqs)
        assert eng.tp == 2 and eng.plan.shards_model
        assert len(eng._cache) == 2 and "ssm" in eng._cache[0]


def test_launcher_serves_through_gateway_on_cpu(capsys):
    from repro_torch.launch.serve import main
    engine, reqs = main(["--gateway", "--device", "cpu", "--n-requests",
                         "6"])
    assert len(reqs) == 6
    assert all(r.state == port_serving.RequestState.FINISHED for r in reqs)
    assert engine.metrics.completed == 6 and engine.metrics.shed == 0
    assert "gateway verdicts: {'accept': 6}" in capsys.readouterr().out


def test_launcher_serves_on_cpu():
    from repro_torch.launch.serve import main
    engine, reqs = main(["--device", "cpu", "--n-requests", "4",
                         "--step-mode", "orchestrated"])
    assert engine.metrics.completed == 4
    assert all(r.generated > 0 for r in reqs)


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_serves_recurrent_families_on_cpu(arch):
    from repro_torch.launch.serve import main
    engine, reqs = main(["--arch", arch, "--device", "cpu", "--n-requests",
                         "4"])
    assert engine.metrics.completed == 4
    assert engine.metrics.prefills == 4
    assert all(r.generated > 0 for r in reqs)
