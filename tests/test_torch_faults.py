"""The port's fault toolkit (repro_torch.testing.faults) against the
reference's, mirroring tests/test_faults.py: aborts in every lifecycle
state leak nothing, injected KV and predictor faults are survived with
conserved block accounting, node kill and slow events re-route cleanly,
and a stall raises with its diagnosis.

Each engine scenario runs on both packages with the same inputs and
weights (tests/torch_parity.py), asserts the reference test's own claims
on each, and holds request states, reasons, streams and engine counters
equal.  The requests are greedy, and the swap-in fault also runs at the
paper's temperature 0.6 (the reference's tests' default), where the fused
step draws the reference's threefry categorical.  The predictor,
scheduler, cluster and workload scenarios are host numpy in both packages
and are held bit-identical.
"""

import functools

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.simulator as ref_sim
import repro.testing as ref_testing
import repro_torch.core as port_core
import repro_torch.simulator as port_sim
import repro_torch.testing as port_testing
from repro_torch.configs import get_config
from torch_parity import PORT, REF, counters, engine, request_record

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
VOCAB = get_config(ARCH, reduced=True).vocab_size


def _engine(pkg, n_slots=2, predictor=None, policy="fcfs", **kw):
    core, _, testing, _, _ = pkg
    sched = (core.Scheduler(policy=core.make_policy(policy),
                            predictor=predictor)
             if predictor is not None
             else core.Scheduler(policy=core.make_policy(policy)))
    return engine(pkg, ARCH, scheduler=sched, n_slots=n_slots,
                  max_seq_len=96, seed=0, clock=testing.VirtualClock(), **kw)


def _req(pkg, i, prompt="p", max_new=6, n_prompt=6, **kw):
    rng = np.random.default_rng(i)
    toks = [int(t) for t in rng.integers(3, VOCAB, n_prompt)]
    return pkg[1].ServeRequest(request_id=f"f{i}", prompt=prompt,
                               prompt_tokens=toks, max_new_tokens=max_new,
                               eos_token=0, temperature=0.0, **kw)


def _swap_engine(pkg, temperature=0.0):
    """Tight-capacity swap-mode engine stepped until some request is
    parked in SWAPPED state (capacity-forced preemption)."""
    core, serving, testing, _, _ = pkg
    o = core.OraclePredictor()
    for i in range(6):
        o.register(f"p{i}", core.LengthDistribution(np.array([8 + 3 * i]),
                                                    np.array([1.0])))
    eng = engine(pkg, ARCH, scheduler=core.Scheduler(
        policy=core.make_policy("sagesched"), predictor=o),
        n_slots=2, max_seq_len=96, capacity_tokens=56, block_size=8,
        preemption_mode="swap", seed=0, clock=testing.VirtualClock())
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(6):
        toks = [int(t) for t in rng.integers(3, VOCAB,
                                             int(rng.integers(6, 14)))]
        reqs.append(serving.ServeRequest(
            request_id=f"f{i}", prompt=f"p{i}", prompt_tokens=toks,
            max_new_tokens=8 + 3 * i, eos_token=1, temperature=temperature,
            arrival=float(i) * 1e-3))
    eng.submit_batch(reqs)
    swapped = None
    for _ in range(200):
        eng.step()
        swapped = next((r for r in reqs
                        if r.state == serving.RequestState.SWAPPED), None)
        if swapped is not None:
            break
    assert swapped is not None, "scenario must park a request in SWAPPED"
    return eng, swapped, reqs


def _record(eng, reqs, *extra):
    return (request_record(reqs), counters(eng)) + extra


def _both(scenario):
    got, want = scenario(PORT), scenario(REF)
    assert got == want


# ------------------------------------------------ aborts leak nothing

def test_abort_waiting_request_releases_everything():
    def scenario(pkg):
        _, serving, testing, _, _ = pkg
        eng = _engine(pkg, n_slots=1)
        reqs = [_req(pkg, i, max_new=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        assert all(r.state == serving.RequestState.WAITING for r in reqs)
        eng.abort("f2", reason="client_cancel")
        assert reqs[2].state == serving.RequestState.ABORTED
        assert reqs[2].finish_reason == "client_cancel"
        eng.kv.assert_conserved()
        eng.run_until_done(max_steps=500)
        testing.assert_engine_quiesced(eng)
        assert eng.kv.free_slots == 1 and eng.kv.used_tokens == 0
        return _record(eng, reqs)

    _both(scenario)


def test_abort_running_request_releases_everything():
    def scenario(pkg):
        _, serving, testing, _, _ = pkg
        eng = _engine(pkg, n_slots=2)
        reqs = [_req(pkg, i, max_new=32) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        running = next(r for r in reqs
                       if r.state == serving.RequestState.RUNNING)
        eng.abort(running.request_id)
        eng.kv.assert_conserved()
        assert not eng.kv.holds(running.request_id)
        eng.run_until_done(max_steps=2000)
        testing.assert_engine_quiesced(eng)
        assert eng.kv.used_tokens == 0 and eng.kv.swapped_tokens == 0
        assert eng.metrics.aborted == 1
        return _record(eng, reqs, running.request_id)

    _both(scenario)


def test_abort_swapped_request_releases_host_payload():
    def scenario(pkg):
        _, serving, testing, _, _ = pkg
        eng, swapped, reqs = _swap_engine(pkg)
        rid = swapped.request_id
        assert eng.kv.is_swapped(rid) and eng.kv.swapped_tokens > 0
        eng.abort(rid, reason="client_cancel")
        assert not eng.kv.is_swapped(rid)
        assert eng.metrics.wasted_tokens >= swapped.generated > 0
        eng.kv.assert_conserved()
        eng.run_until_done(max_steps=2000)
        assert all(r.state == serving.RequestState.FINISHED
                   for r in reqs if r is not swapped)
        testing.assert_engine_quiesced(eng)
        assert eng.kv.used_tokens == 0 and eng.kv.swapped_tokens == 0
        assert eng.kv.free_slots == 2
        return _record(eng, reqs, rid)

    _both(scenario)


def test_abort_mid_chunked_prefill_releases_everything():
    def scenario(pkg):
        _, _, testing, _, _ = pkg
        eng = _engine(pkg, n_slots=1, prefill_chunk=4)
        r = _req(pkg, 0, max_new=8, n_prompt=14)
        eng.submit(r)
        eng.step()
        pos = r.prefill_pos
        assert 0 < pos < len(r.prompt_tokens)
        eng.abort("f0")
        eng.kv.assert_conserved()
        assert eng.kv.used_tokens == 0 and eng.kv.free_slots == 1
        assert r.prefill_pos == 0
        testing.assert_engine_quiesced(eng)
        return _record(eng, [r], pos)

    _both(scenario)


def test_abort_terminal_states_is_idempotent():
    def scenario(pkg):
        _, serving, _, _, _ = pkg
        eng = _engine(pkg, n_slots=1)
        r = _req(pkg, 0, max_new=4)
        eng.submit(r)
        eng.run_until_done(max_steps=500)
        assert r.state == serving.RequestState.FINISHED
        before = (eng.metrics.aborted, r.finish_reason)
        eng.abort("f0")
        eng.abort("f0")
        assert (eng.metrics.aborted, r.finish_reason) == before
        eng.kv.assert_conserved()
        return _record(eng, [r])

    _both(scenario)


# ------------------------------------------ a stall raises its diagnosis

def test_run_until_done_exhaustion_raises_diagnostic():
    def scenario(pkg):
        _, serving, testing, _, _ = pkg
        eng = _engine(pkg, n_slots=1)
        r = _req(pkg, 0, max_new=40)
        eng.submit(r)
        with pytest.raises(serving.EngineStallError) as ei:
            eng.run_until_done(max_steps=1)
        msg = str(ei.value)
        assert "step budget (1)" in msg
        assert "request_states" in msg and "queue_depth" in msg
        assert "conservation" in msg or "free_blocks" in msg
        eng.run_until_done(max_steps=2000)
        testing.assert_engine_quiesced(eng)
        return _record(eng, [r], msg)

    _both(scenario)


# ------------------------------------------------ injected KV faults

def _swap_in_fault(pkg, temperature=0.0):
    _, serving, testing, _, _ = pkg
    eng, _, reqs = _swap_engine(pkg, temperature)
    with testing.inject_kv_fault(eng.kv, "swap_in", at_call=0,
                                 n_calls=1) as stats:
        eng.run_until_done(max_steps=2000)
    assert stats["faults"] == 1
    assert eng.metrics.swap_in_faults == 1
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    testing.assert_engine_quiesced(eng)
    return _record(eng, reqs, dict(stats))


def test_swap_in_fault_falls_back_to_recompute():
    _both(_swap_in_fault)


def test_swap_in_fault_sampled_at_the_paper_temperature():
    """The same fault at temperature 0.6: the recompute fallback draws
    each position from the same (request, position) key, so the records
    are the reference's, and they are not the greedy ones."""
    _both(functools.partial(_swap_in_fault, temperature=0.6))
    assert _swap_in_fault(PORT, 0.6)[0] != _swap_in_fault(PORT)[0]


def test_grow_fault_is_absorbed_by_pressure_relief():
    def scenario(pkg):
        _, _, testing, _, _ = pkg
        eng = _engine(pkg, n_slots=2)
        reqs = [_req(pkg, i, max_new=24, n_prompt=10) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        with testing.inject_kv_fault(eng.kv, "grow", at_call=2,
                                     n_calls=3) as stats:
            eng.run_until_done(max_steps=4000)
        assert stats["faults"] >= 1
        testing.assert_engine_quiesced(eng)
        assert eng.kv.used_tokens == 0
        return _record(eng, reqs, dict(stats))

    _both(scenario)


def test_inject_kv_fault_restores_method():
    def scenario(pkg):
        _, _, testing, _, _ = pkg
        eng = _engine(pkg, n_slots=1)
        orig = eng.kv.swap_in
        with pytest.raises(testing.KVFaultError):
            with testing.inject_kv_fault(eng.kv, "swap_in"):
                eng.kv.swap_in("nope")
        assert eng.kv.swap_in == orig
        return counters(eng)

    _both(scenario)


# ---------------------------------------- predictor faults / degraded

def test_flaky_predictor_modes():
    def scenario(core, testing):
        inner = core.OraclePredictor()
        inner.register("a", core.LengthDistribution(np.array([10]),
                                                    np.array([1.0])))
        inner.register("b", core.LengthDistribution(np.array([100]),
                                                    np.array([1.0])))
        out = testing.FlakyPredictor(inner, mode="outage", fail_after=1)
        assert out.predict("a", 8).mean == 10.0
        with pytest.raises(testing.PredictorUnavailable):
            out.predict("a", 8)
        corrupt = testing.FlakyPredictor(inner, mode="corrupt",
                                         corrupt_scale=16.0)
        d = corrupt.predict("a", 8)
        assert d.lengths.tolist() == [160] and corrupt.faults == 1
        stale = testing.FlakyPredictor(inner, mode="stale", fail_after=1)
        assert stale.predict("a", 8).mean == 10.0
        assert stale.predict("b", 8).mean == 10.0
        drift = testing.scale_distribution(
            core.LengthDistribution(np.array([3, 4, 10]),
                                    np.array([0.2, 0.3, 0.5])), 0.5, 1.0)
        return (out.calls, out.faults, corrupt.calls, stale.calls,
                stale.faults, d.lengths.tolist(), d.probs.tolist(),
                drift.lengths.tolist(), drift.probs.tolist())

    assert scenario(port_core, port_testing) == \
        scenario(ref_core, ref_testing)


def test_scheduler_degrades_and_recovers_on_predictor_outage():
    def scenario(core, testing):
        flaky = testing.FlakyPredictor(core.SemanticHistoryPredictor(),
                                       mode="outage", fail_after=0,
                                       n_failures=1)
        sched = core.Scheduler(policy=core.make_policy("sagesched"),
                               predictor=flaky)
        sched.admit_batch(["d0", "d1"], ["p0", "p1"], [8, 8],
                          arrivals=[0.0, 0.0])
        assert sched.degraded
        assert sched.stats["prediction_failures"] == 2
        order = sched.order(["d0", "d1"])
        assert order
        sched.admit("d2", "p2", 8, arrival=0.1)
        assert sched.degraded
        sched.admit_batch(["d3", "d4", "d5"], ["p3", "p4", "p5"], [8, 8, 8],
                          arrivals=[0.2, 0.2, 0.2])
        assert not sched.degraded
        flaky2 = testing.FlakyPredictor(core.SemanticHistoryPredictor(),
                                        mode="outage", fail_after=0,
                                        n_failures=1)
        sched2 = core.Scheduler(policy=core.make_policy("sagesched"),
                                predictor=flaky2, degraded_exit_successes=2)
        sched2.admit("e0", "p0", 8, arrival=0.0)
        assert sched2.degraded
        sched2.admit("e1", "p1", 8, arrival=0.1)
        assert sched2.degraded
        sched2.admit("e2", "p2", 8, arrival=0.2)
        assert not sched2.degraded
        return order, sched.order(), dict(sched.stats), sched2.order()

    assert scenario(port_core, port_testing) == \
        scenario(ref_core, ref_testing)


# ------------------------------------------- cluster node kill / slow

def _workload(sim, n=40, rps=10.0, seed=3):
    profiles = [sim.make_profile("sharegpt", n_clusters=4, seed=1)]
    return sim.generate_workload(profiles, n, rps=rps, seed=seed)


def _key(res):
    return sorted((m.request_id, m.node_id, m.ttft, m.ttlt, m.n_preemptions)
                  for m in res.metrics)


def _cluster(sim, core, n_nodes, faults=None, **kw):
    reqs = _workload(sim, **kw.pop("workload", {}))
    res = sim.simulate_cluster(reqs, lambda: core.Scheduler(), n_nodes,
                               faults=faults, **kw)
    return reqs, res


def _both_clusters(make_faults, n_nodes, **kw):
    """Port and reference cluster runs on the same workload and faults:
    per-request metrics, aborts and migrations bit-identical."""
    out = []
    for sim, core in ((port_sim, port_core), (ref_sim, ref_core)):
        faults = make_faults(sim) if make_faults else None
        out.append(_cluster(sim, core, n_nodes, faults=faults, **dict(kw)))
    (reqs, res), (_, ref_res) = out
    assert _key(res) == _key(ref_res)
    assert (res.aborted, res.migrated, res.requests_per_node) == \
        (ref_res.aborted, ref_res.migrated, ref_res.requests_per_node)
    assert (res.mean_ttft, res.mean_ttlt) == (ref_res.mean_ttft,
                                              ref_res.mean_ttlt) \
        or np.isnan(res.mean_ttlt) and np.isnan(ref_res.mean_ttlt)
    return reqs, res


def test_cluster_without_faults_is_bit_identical():
    _, a = _both_clusters(None, 3)
    _, b = _both_clusters(lambda sim: [], 3)
    ka = sorted((m.request_id, m.ttft, m.ttlt, m.node_id) for m in a.metrics)
    kb = sorted((m.request_id, m.ttft, m.ttlt, m.node_id) for m in b.metrics)
    assert ka == kb and b.migrated == 0 and b.aborted == []


def test_cluster_node_kill_reroutes_without_dangling_rows():
    out = []
    for sim, core in ((port_sim, port_core), (ref_sim, ref_core)):
        reqs = _workload(sim)
        created = []

        def factory(core=core, created=created):
            created.append(core.Scheduler())
            return created[-1]

        res = sim.simulate_cluster(reqs, factory, 3,
                                   faults=[sim.NodeKill(1, at=1.0)])
        accounted = {m.request_id for m in res.metrics} | set(res.aborted)
        assert accounted == {r.request_id for r in reqs}
        assert res.migrated > 0 and res.aborted == []
        assert len(created) == 1 and len(created[0]) == 0
        for m in res.node_results[1].metrics:
            assert m.arrival + m.ttlt <= 1.0 + 1e-9
        assert all(m.node_id != 1 for m in res.metrics
                   if m.arrival + m.ttlt > 1.0 + 1e-9)
        out.append((_key(res), res.migrated))
    assert out[0] == out[1]


def test_cluster_node_kill_cost_router_parity_of_accounting():
    for shared in (True, False):
        reqs, res = _both_clusters(lambda sim: [sim.NodeKill(2, at=1.2)], 3,
                                   router="cost", shared_state=shared)
        accounted = {m.request_id for m in res.metrics} | set(res.aborted)
        assert accounted == {r.request_id for r in reqs}


def test_cluster_slow_node_degrades_latency():
    _, base = _both_clusters(None, 2)
    _, slow = _both_clusters(
        lambda sim: [sim.NodeSlow(0, at=0.5, factor=8.0)], 2)
    assert len(slow.metrics) == len(base.metrics)
    assert slow.mean_ttlt > base.mean_ttlt


def test_cluster_total_outage_aborts_everything():
    reqs, res = _both_clusters(
        lambda sim: [sim.NodeKill(0, at=0.4), sim.NodeKill(1, at=0.5)], 2,
        workload=dict(n=20))
    assert set(res.aborted) | {m.request_id for m in res.metrics} \
        == {r.request_id for r in reqs}
    assert len(res.aborted) > 0


# ------------------------------------------------ workload burst overload

def _trace(reqs):
    return [(r.request_id, r.arrival, r.prompt, r.input_len,
             r.true_output_len, r.dataset) for r in reqs]


def test_workload_burst_factor_one_is_seed_identical():
    profiles = [port_sim.make_profile("sharegpt", n_clusters=4, seed=1)]
    a = port_sim.generate_workload(profiles, 50, rps=5.0, seed=7)
    b = port_sim.generate_workload(profiles, 50, rps=5.0, seed=7,
                                   burst_factor=1.0)
    assert [r.arrival for r in a] == [r.arrival for r in b]
    assert [r.prompt for r in a] == [r.prompt for r in b]
    assert _trace(a) == _trace(_workload(ref_sim, n=50, rps=5.0, seed=7))


def test_workload_bursts_compress_arrivals():
    kw = dict(burst_factor=10.0, burst_period_s=10.0, burst_duty=0.5)
    traces = []
    for sim in (port_sim, ref_sim):
        profiles = [sim.make_profile("sharegpt", n_clusters=4, seed=1)]
        base = sim.generate_workload(profiles, 200, rps=5.0, seed=7)
        burst = sim.generate_workload(profiles, 200, rps=5.0, seed=7, **kw)
        assert burst[-1].arrival < base[-1].arrival
        traces.append((_trace(base), _trace(burst)))
    assert traces[0] == traces[1]


# --------------------------------------------------------------- clock

def test_virtual_clock_is_monotonic():
    for testing in (port_testing, ref_testing):
        clk = testing.VirtualClock(start=2.0)
        assert clk() == 2.0
        assert clk.advance(0.5) == 2.5
        with pytest.raises(ValueError):
            clk.advance(-0.1)
