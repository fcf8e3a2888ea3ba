"""Copy-on-write prefix sharing of the port's engine (repro_torch.serving)
against the reference's (repro.serving), mirroring
tests/test_prefix_sharing.py.

Sharing is a pure cost optimisation: streams with ``prefix_sharing=True``
equal the sharing-off streams, and ``prefill_tokens_reused`` counts the
prefill work skipped.  Every case here runs the port and the reference on
the same inputs and the same weights (the reference's, upcast to f32 on
both sides, with the reference's conv cache started in f32: see
tests/test_torch_engine.py) and holds the port's streams, engine counters
and ``prefill_tokens_reused`` equal to the reference's, and the port's
sharing-on run equal to its own sharing-off run.  The recurrent families
cannot resume a prefill mid-context, so sharing is inert for them.  The
MoE (olmoe-1b-7b) and VLM (internvl2-76b) rows are the reference's too:
a resumed chunk has the shape and tokens of the sharing-off chunk, so
the MoE routes it with the same capacity.

Also mirrored: session traffic through the Gateway, the session workload
generator and the cluster simulator's node-level sharing, each held
bit-identical to the reference.
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.simulator as ref_sim
import repro_torch.core as port_core
import repro_torch.simulator as port_sim
from repro.simulator.workload import \
    generate_session_workload as ref_session_workload
from repro_torch.configs import get_config
from repro_torch.simulator.workload import generate_session_workload
from torch_parity import PORT, REF, counters, engine
from torch_sessions import session_drive

torch.set_num_threads(1)

FAMILIES = ["llama3.2-1b", "mamba2-2.7b", "zamba2-1.2b", "olmoe-1b-7b",
            "internvl2-76b"]
KV_CHUNKED = {"llama3.2-1b", "olmoe-1b-7b", "internvl2-76b"}


def _run(pkg, arch, *, sharing, pmode="swap", step_mode="fused",
         temperature=0.0, n=4, n_slots=2, cap=96):
    """tests/test_prefix_sharing.py's ``_run``: ``n`` requests sharing a
    24-token base prefix, run to completion."""
    core, serving, testing, get_cfg, _ = pkg
    cfg = get_cfg(arch, reduced=True)
    o = core.OraclePredictor()
    for i in range(n):
        o.register(f"p{i}", core.LengthDistribution(np.array([6 + 2 * i]),
                                                    np.array([1.0])))
    eng = engine(pkg, arch, scheduler=core.Scheduler(
        policy=core.make_policy("sagesched"), predictor=o),
        n_slots=n_slots, max_seq_len=96, capacity_tokens=cap, block_size=8,
        preemption_mode=pmode, prefill_chunk=16, seed=0,
        step_mode=step_mode, prefix_sharing=sharing)
    rng = np.random.default_rng(11)
    base = [int(t) for t in rng.integers(3, cfg.vocab_size, 24)]
    reqs = []
    for i in range(n):
        toks = base + [int(t) for t in rng.integers(3, cfg.vocab_size,
                                                    4 + i)]
        reqs.append(serving.ServeRequest(
            f"r{i}", f"p{i}", toks, max_new_tokens=6 + 2 * i,
            temperature=temperature, eos_token=1, arrival=float(i) * 1e-3))
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=8000)
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    testing.assert_engine_quiesced(eng)
    return eng, [r.output_tokens for r in reqs]


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("pmode", ["swap", "recompute"])
def test_sharing_is_token_identical(arch, pmode):
    """Sharing ON == OFF for every served family, preemption mode and step
    mode, each run equal to the reference's (streams and counters)."""
    for step_mode in ("fused", "orchestrated"):
        runs = {}
        for sharing in (False, True):
            ep, got = _run(PORT, arch, sharing=sharing, pmode=pmode,
                           step_mode=step_mode)
            er, want = _run(REF, arch, sharing=sharing, pmode=pmode,
                            step_mode=step_mode)
            assert got == want, (step_mode, sharing)
            assert counters(ep) == counters(er), (step_mode, sharing)
            runs[sharing] = (ep, got)
        (off, want), (on, got) = runs[False], runs[True]
        assert got == want, f"{arch}/{pmode}/{step_mode} streams diverged"
        assert off.metrics.prefill_tokens_reused == 0
        if arch in KV_CHUNKED:
            assert on.metrics.prefill_tokens_reused > 0
            assert (on.metrics.prefill_tokens
                    + on.metrics.prefill_tokens_reused
                    == off.metrics.prefill_tokens)
        else:
            assert on.metrics.prefill_tokens_reused == 0
            assert on.metrics.prefill_tokens == off.metrics.prefill_tokens


def test_sharing_parity_survives_stochastic_sampling():
    """At temperature 0.7 the fused path draws the reference's threefry
    categorical (keyed by request and position): the streams, the reuse
    and the counters are held to the reference's sampled run, and the
    port's sharing-on streams to its sharing-off ones."""
    on, got = _run(PORT, "llama3.2-1b", sharing=True, temperature=0.7)
    off, want = _run(PORT, "llama3.2-1b", sharing=False, temperature=0.7)
    ref_on, ref_got = _run(REF, "llama3.2-1b", sharing=True, temperature=0.7)
    assert got == want == ref_got
    assert on.metrics.prefill_tokens_reused > 0
    assert counters(on) == counters(ref_on)
    _, greedy = _run(PORT, "llama3.2-1b", sharing=True)
    assert got != greedy               # the noise is really drawn


def test_sharing_parity_multi_tenant_prefixes():
    """Two distinct system prompts: matches never cross prefix chains (a
    wrong-chain adoption would corrupt tokens, so parity detects it)."""
    cfg = get_config("llama3.2-1b", reduced=True)
    rng = np.random.default_rng(5)
    bases = [[int(t) for t in rng.integers(3, cfg.vocab_size, 24)]
             for _ in range(2)]

    def build(pkg, sharing):
        core, serving, testing, _, _ = pkg
        o = core.OraclePredictor()
        for i in range(6):
            o.register(f"p{i}", core.LengthDistribution(np.array([6]),
                                                        np.array([1.0])))
        eng = engine(pkg, "llama3.2-1b", scheduler=core.Scheduler(
            policy=core.make_policy("sagesched"), predictor=o),
            n_slots=2, max_seq_len=96, capacity_tokens=128, block_size=8,
            prefill_chunk=16, seed=0, prefix_sharing=sharing)
        srng = np.random.default_rng(9)
        reqs = [serving.ServeRequest(
            f"r{i}", f"p{i}",
            bases[i % 2] + [int(t) for t in srng.integers(
                3, cfg.vocab_size, 3 + i)],
            max_new_tokens=6, temperature=0.0, eos_token=1,
            arrival=float(i) * 1e-3) for i in range(6)]
        eng.submit_batch(reqs)
        eng.run_until_done(max_steps=8000)
        testing.assert_engine_quiesced(eng)
        return eng, [r.output_tokens for r in reqs]

    _, want = build(PORT, False)
    on, got = build(PORT, True)
    ref_on, ref_got = build(REF, True)
    assert got == want == ref_got
    assert on.metrics.prefill_tokens_reused > 0
    assert counters(on) == counters(ref_on)


def test_gateway_session_traffic_reuses_prefixes():
    """Shared-system-prompt sessions through the Gateway: the engine
    adopts prefixes, every request terminates, the quiesced-engine
    invariants hold, and streams, dispositions and counters equal the
    reference's Gateway over the reference's engine.  The requests are
    greedy (the reference's test samples at the default 0.6): the port's
    sampled draws are its own, and a greedy stream is the one the
    reference can be held to."""
    cfg = get_config("llama3.2-1b", reduced=True)

    def run(pkg):
        core, serving, testing, _, _ = pkg
        o = core.OraclePredictor()
        o.register("p", core.LengthDistribution(np.array([6]),
                                                np.array([1.0])))
        eng = engine(pkg, "llama3.2-1b", scheduler=core.Scheduler(
            policy=core.make_policy("fcfs"), predictor=o),
            n_slots=2, max_seq_len=96, capacity_tokens=128, block_size=8,
            prefill_chunk=16, seed=0, clock=testing.VirtualClock(),
            prefix_sharing=True)
        gw = serving.Gateway(eng, serving.GatewayConfig(max_inflight=4))
        rng = np.random.default_rng(3)
        system = [int(t) for t in rng.integers(3, cfg.vocab_size, 24)]
        reqs = [serving.ServeRequest(
            f"s{i}", "p", system + [int(t) for t in rng.integers(
                3, cfg.vocab_size, 4)],
            max_new_tokens=6, eos_token=1, tenant="acme",
            session_id=f"sess-{i}", temperature=0.0) for i in range(5)]
        verdicts = [v.value for v in gw.offer_batch(reqs)]
        gw.run_until_drained(max_steps=5000)
        gw.assert_all_terminal()
        gw.check_invariants()
        assert all(r.state == serving.RequestState.FINISHED for r in reqs)
        assert eng.metrics.prefill_tokens_reused > 0
        testing.assert_engine_quiesced(eng)
        return (verdicts, dict(gw.dispositions),
                [r.output_tokens for r in reqs], counters(eng))

    assert run(PORT) == run(REF)


PROFILES = [port_sim.make_profile(n) for n in ("sharegpt", "alpaca", "write")]
REF_PROFILES = [ref_sim.make_profile(n)
                for n in ("sharegpt", "alpaca", "write")]


def _session_key(reqs):
    return [(r.request_id, r.arrival, r.prompt, r.input_len,
             r.true_output_len, r.prefix_group, r.shared_prefix_len,
             r.sharable_prefix_len, r.dataset, r.drift_factor) for r in reqs]


def test_session_workload_generator_is_consistent():
    """Deterministic per seed, equal to the reference's generator, and the
    session chains are well formed."""
    a = generate_session_workload(PROFILES, 40, rps=10.0, seed=7)
    b = generate_session_workload(PROFILES, 40, rps=10.0, seed=7)
    assert _session_key(a) == _session_key(b)
    assert _session_key(a) == _session_key(
        ref_session_workload(REF_PROFILES, 40, rps=10.0, seed=7))
    assert _session_key(a) != _session_key(
        generate_session_workload(PROFILES, 40, rps=10.0, seed=8))
    assert all(r.arrival <= s.arrival for r, s in zip(a, a[1:]))
    chains: dict[str, list] = {}
    for r in a:
        assert 0 <= r.shared_prefix_len <= r.input_len
        assert 0 <= r.sharable_prefix_len <= r.input_len
        if r.prefix_group.startswith("sess-"):
            chains.setdefault(r.prefix_group, []).append(r)
    assert chains, "no multi-turn sessions generated"
    for turns in chains.values():
        turns.sort(key=lambda r: r.arrival)
        assert turns[0].shared_prefix_len == 0
        for prev, cur in zip(turns, turns[1:]):
            assert cur.shared_prefix_len == (prev.input_len
                                             + prev.true_output_len)
            assert cur.sharable_prefix_len == cur.input_len
            assert cur.input_len > prev.input_len


def test_cluster_session_sharing_reuses_and_speeds_up_ttft():
    """The simulator's node-level mirror: with sharing on, session turns
    skip their cached prefix, mean TTFT can only improve, and every
    request's metrics equal the reference's."""

    def run(sim, profiles, sharing):
        reqs = sim.workload.generate_session_workload(profiles, 60, rps=14.0,
                                                      seed=2)
        core = port_core if sim is port_sim else ref_core
        res = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy("sagesched")),
            2, node_kwargs=dict(prefill_chunk=64, block_size=16,
                                prefix_sharing=sharing))
        node = sim.NodeSimulator(
            core.Scheduler(policy=core.make_policy("sagesched")),
            prefill_chunk=64, block_size=16, prefix_sharing=sharing)
        node.run(list(reqs))
        return reqs, res, node

    for sharing in (False, True):
        reqs, res, node = run(port_sim, PROFILES, sharing)
        _, ref_res, ref_node = run(ref_sim, REF_PROFILES, sharing)
        key = sorted((m.request_id, m.node_id, m.ttft, m.ttlt,
                      m.n_preemptions) for m in res.metrics)
        assert key == sorted((m.request_id, m.node_id, m.ttft, m.ttlt,
                              m.n_preemptions) for m in ref_res.metrics)
        assert (res.mean_ttft, res.mean_ttlt) == (ref_res.mean_ttft,
                                                  ref_res.mean_ttlt)
        assert node.prefill_tokens_reused == ref_node.prefill_tokens_reused
        assert sum(len(r.metrics) for r in res.node_results) == len(reqs)
        if sharing:
            on, on_node = res, node
        else:
            off = res
    assert on.mean_ttft <= off.mean_ttft
    assert on_node.prefill_tokens_reused > 0


# ---------------------------------------------- multi-turn sessions

def _session_drive(pkg, *, sharing, pmode):
    """``torch_sessions.session_drive`` on ``pkg``'s engine, with a
    128-token budget that preempts requests holding adopted blocks."""
    core, serving, testing, get_cfg, _ = pkg
    eng = engine(pkg, "llama3.2-1b", scheduler=core.Scheduler(
        policy=core.make_policy("sagesched")),
        n_slots=2, max_seq_len=160, capacity_tokens=128, block_size=8,
        prefill_chunk=16, seed=0, preemption_mode=pmode,
        prefix_sharing=sharing)
    streams, counts = session_drive(
        eng, serving, get_cfg("llama3.2-1b", reduced=True).vocab_size)
    testing.assert_engine_quiesced(eng)
    return eng, streams, counts


@pytest.mark.parametrize("pmode", ["swap", "recompute"])
def test_session_turns_readopt_cached_blocks_and_preempt_sharers(pmode):
    """Turn t + 1 adopts blocks turn t released (the cached tier, where a
    stray write into a freed block would corrupt a later turn), and the
    scheduler preempts requests holding adopted blocks (swap: the payload
    holds the adopted blocks, and swap-in re-adopts them).  ON == OFF,
    and each run equal to the reference's, counts included."""
    runs = {}
    for sharing in (False, True):
        ep, got, counts = _session_drive(PORT, sharing=sharing, pmode=pmode)
        er, want, ref_counts = _session_drive(REF, sharing=sharing,
                                              pmode=pmode)
        assert got == want, sharing
        assert counters(ep) == counters(er), sharing
        assert counts == ref_counts, sharing
        runs[sharing] = (ep, got, counts)
    (_, off, _), (on, got, counts) = runs[False], runs[True]
    assert got == off
    assert on.metrics.prefill_tokens_reused > 0
    assert counts["cached_adopted"] > 0
    assert counts["adopted_preempts"] > 0
    if pmode == "swap":
        assert counts["adopted_swaps"] > 0
