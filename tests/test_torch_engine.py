"""Serving engine of the port (repro_torch.serving) against the reference
(repro.serving), and the port's own invariants.

The same greedy requests, scheduler and weights (the reference's, upcast
to f32 on both sides) go through both engines: token streams and the
preemption / swap counters must be identical, in both step modes and both
preemption modes.  Inside the port: fused == orchestrated, swap ==
recompute, multi-step == single-step, and for temperature > 0 the fused
path's Gumbel draws are invariant to preemption mode and slot.
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
from repro_torch.serving.engine import gumbel_noise

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "llama3.2-1b"
COUNTERS = ("preemptions", "swap_outs", "swap_ins", "forced_evictions",
            "grow_failures", "prefills", "prefill_chunks", "prefill_tokens",
            "decode_tokens", "completed")


@pytest.fixture(scope="module")
def weights():
    cfg = ref_get_config(ARCH, reduced=True)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


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
         temperature=0.0, order=None):
    """Reduced llama3.2-1b, an oracle predictor, a KV budget small enough
    to force preemption, chunked prefill mixed with decode."""
    core, serving, get_cfg, build = pkg
    cfg = get_cfg(ARCH, reduced=True)
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
    reqs = _requests(serving, cfg.vocab_size, n, temperature, order)
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=4000)
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    streams = {r.request_id: r.output_tokens for r in reqs}
    return eng, [streams[f"r{i}"] for i in range(n)]


REF = (ref_core, ref_serving, ref_get_config, ref_build_model)
PORT = (port_core, port_serving, get_config, build_model)


@pytest.mark.parametrize("preemption_mode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_streams_and_counters_match_reference(weights, step_mode,
                                              preemption_mode):
    ref_params, params = weights
    er, want = _run(REF, ref_params, step_mode=step_mode,
                    preemption_mode=preemption_mode)
    ep, got = _run(PORT, params, step_mode=step_mode,
                   preemption_mode=preemption_mode)
    assert got == want
    assert er.metrics.preemptions > 0
    for name in COUNTERS:
        assert getattr(ep.metrics, name) == getattr(er.metrics, name), name


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
    seeds = torch.tensor([5, 2**32 - 1, 12345], dtype=torch.int64)
    pos = torch.tensor([0, 7, 7], dtype=torch.int64)
    a = gumbel_noise(0, seeds, pos, 1000)
    assert a.shape == (3, 1000) and torch.isfinite(a).all()
    assert torch.equal(a[1:2], gumbel_noise(0, seeds[1:2], pos[1:2], 1000))
    assert not torch.equal(a, gumbel_noise(1, seeds, pos, 1000))
    # a standard Gumbel: mean = Euler-Mascheroni constant, var = pi^2 / 6
    assert abs(float(a.mean()) - 0.5772) < 0.1
    assert abs(float(a.var()) - 1.6449) < 0.3


def test_unported_options_refuse():
    cfg = get_config(ARCH, reduced=True)
    sched = port_core.Scheduler(policy="sagesched")
    for kw, item in (({"tp": 2}, "Queue A 10"),
                     ({"device_memory_gb": 1.0}, "Queue A 11"),
                     ({"prefix_sharing": True}, "Queue A 5")):
        with pytest.raises(NotImplementedError, match=item):
            port_serving.ServingEngine(model=build_model(cfg),
                                       scheduler=sched, device="cpu", **kw)


def test_launcher_gateway_refuses():
    from repro_torch.launch.serve import main
    with pytest.raises(NotImplementedError, match="Queue A 8"):
        main(["--gateway", "--device", "cpu"])


def test_launcher_serves_on_cpu():
    from repro_torch.launch.serve import main
    engine, reqs = main(["--device", "cpu", "--n-requests", "4",
                         "--step-mode", "orchestrated"])
    assert engine.metrics.completed == 4
    assert all(r.generated > 0 for r in reqs)
