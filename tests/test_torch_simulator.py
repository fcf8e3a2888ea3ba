"""The port's discrete-event simulator, cluster and workload generator
(repro_torch.simulator) against the reference's (repro.simulator),
mirroring tests/test_simulator.py and tests/test_cluster.py.

Both are host numpy over the same scheduler core, so every case runs the
same seeds through both packages, asserts the reference test's own claims
on each, and holds the per-request ``SimResult`` / ``ClusterResult``
metrics bit-identical.  ``measure_scheduler_overhead`` returns wall-clock
latencies, which are never bit-identical: it is held for its keys and
structure only.
"""

import numpy as np
import pytest

import repro.core as ref_core
import repro.simulator as ref_sim
import repro_torch.core as port_core
import repro_torch.simulator as port_sim
from repro.simulator.workload import SimRequest as RefSimRequest
from repro_torch.simulator.workload import SimRequest

PKGS = ((port_sim, port_core), (ref_sim, ref_core))


def _profiles(sim):
    return [sim.make_profile(n) for n in ("sharegpt", "alpaca", "write")]


def _metric_key(result):
    """Per-request comparison key (exact float equality)."""
    return sorted((m.request_id, m.node_id, m.ttft, m.ttlt, m.n_preemptions)
                  for m in result.metrics)


def _sim_key(res):
    return (_metric_key(res), res.makespan, res.n_evictions,
            res.mean_ttlt(), res.mean_ttft())


def _trace(reqs):
    return [(r.request_id, r.arrival, r.prompt, r.input_len,
             r.true_output_len, r.dataset, r.cluster.cluster_id)
            for r in reqs]


def _both(scenario):
    """``scenario(sim, core)`` on the port and on the reference; the
    records must be equal."""
    got, want = (scenario(sim, core) for sim, core in PKGS)
    assert got == want
    return got


def _perfect_oracle(core, reqs):
    o = core.OraclePredictor()
    for r in reqs:
        o.register(r.prompt, core.LengthDistribution(
            np.array([r.true_output_len]), np.array([1.0])))
    return o


# ----------------------------------------------- tests/test_simulator.py

def test_service_model_regimes():
    def scenario(sim, core):
        sm = sim.ServiceModel(sim.NodeSpec())
        t1 = sm.decode_iteration_time(1, 100)
        t2 = sm.decode_iteration_time(1, 100_000)
        assert t2 > t1
        steps = sum(sm.decode_iteration_time(4, 1000 + 4 * i)
                    for i in range(10))
        closed = sm.decode_run_time(4, 1000, 10)
        assert closed == pytest.approx(steps, rel=1e-9)
        return t1, t2, steps, closed

    _both(scenario)


def test_workload_generation_poisson_and_profiles():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 200, rps=10.0, seed=0)
        assert len(reqs) == 200
        arr = np.diff([r.arrival for r in reqs])
        assert np.mean(arr) == pytest.approx(0.1, rel=0.3)
        alp = [r for r in reqs if r.dataset == "alpaca"]
        wri = [r for r in reqs if r.dataset == "write"]
        assert np.median([r.input_len for r in alp]) > \
            np.median([r.input_len for r in wri])
        return _trace(reqs)

    _both(scenario)


def test_simulation_conservation():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 100, rps=6.0, seed=2)
        res = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("fcfs")))
        assert len(res.metrics) == 100
        for m in res.metrics:
            assert np.isfinite(m.ttlt) and m.ttlt > 0
            assert np.isfinite(m.ttft) and 0 < m.ttft <= m.ttlt + 1e-9
        assert res.makespan >= max(m.arrival + m.ttlt
                                   for m in res.metrics) - 1e-6
        return _sim_key(res)

    _both(scenario)


def test_sjf_oracle_beats_fcfs_under_load():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 300, rps=10.0, seed=3)
        fcfs = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("fcfs")))
        sjf = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("ssjf"),
            predictor=_perfect_oracle(core, reqs)))
        assert sjf.mean_ttlt() < fcfs.mean_ttlt()
        return _sim_key(fcfs), _sim_key(sjf)

    _both(scenario)


def test_sagesched_beats_fcfs_under_load():
    def scenario(sim, core):
        profiles = _profiles(sim)
        reqs = sim.generate_workload(profiles, 550, rps=10.0, seed=4)
        rng = np.random.default_rng(0)
        sched = core.Scheduler(policy=core.make_policy("sagesched"))
        prompts, ils, ols = [], [], []
        for prof in profiles:
            for c in prof.clusters:
                for _ in range(30):
                    prompts.append(c.sample_prompt(rng))
                    ils.append(c.sample_input_len(rng))
                    ols.append(c.sample_output_len(rng))
        sched.predictor.seed(prompts, ils, ols)
        sage = sim.simulate(reqs, sched)
        fcfs = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("fcfs")))
        assert sage.mean_ttlt() < fcfs.mean_ttlt() * 0.98
        return _sim_key(sage), _sim_key(fcfs)

    _both(scenario)


def test_fastserve_improves_ttft():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 200, rps=10.0, seed=5)
        fcfs = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("fcfs")))
        fs = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("fastserve")))
        assert fs.mean_ttft() < fcfs.mean_ttft()
        return _sim_key(fcfs), _sim_key(fs)

    _both(scenario)


def test_capacity_forces_eviction():
    def scenario(sim, core):
        spec = sim.NodeSpec(hbm_bytes=70e9, weight_bytes=64e9)
        reqs = sim.generate_workload(_profiles(sim), 60, rps=20.0, seed=6)
        res = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("sagesched")), spec)
        assert len(res.metrics) == 60
        assert res.n_evictions > 0
        return _sim_key(res)

    _both(scenario)


def _overhead_structure(o, backend):
    """The keys and types of a ``measure_scheduler_overhead`` record and
    the identities between its fields (not its timings)."""
    assert o["backend"] == backend
    assert o["total_ms"] == pytest.approx(o["predict_ms"] + o["schedule_ms"])
    assert all(np.isfinite(o[k]) and o[k] > 0
               for k in ("predict_ms", "schedule_ms", "total_ms"))
    return sorted(o), {k: o[k] for k in (
        "n_nodes", "aggregate_rps", "queue_depth", "backend", "policy",
        "refresh_rows_per_arrival")}


def test_cluster_routing_and_overhead():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 120, rps=20.0, seed=7)
        cr = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy("fcfs")),
            n_nodes=2)
        assert sum(len(r.metrics) for r in cr.node_results) == 120
        o1 = sim.measure_scheduler_overhead(1, n_probe=10,
                                            history_size=2000)
        o64 = sim.measure_scheduler_overhead(64, n_probe=10,
                                             history_size=2000)
        assert o64["total_ms"] > o1["total_ms"] * 0.5
        assert o64["total_ms"] < 1000
        return (_metric_key(cr), _overhead_structure(o1, "numpy"),
                _overhead_structure(o64, "numpy"))

    _both(scenario)


# ------------------------------------------------- tests/test_cluster.py

def _req(sim, i, arrival, input_len=64, output_len=32, prompt=None):
    c = _profiles(sim)[0].clusters[0]
    cls = SimRequest if sim is port_sim else RefSimRequest
    return cls(request_id=f"r{i:04d}", arrival=arrival,
               prompt=prompt or c.sample_prompt(np.random.default_rng(i)),
               input_len=input_len, true_output_len=output_len,
               dataset="sharegpt", cluster=c)


@pytest.mark.parametrize("policy", ["fcfs", "fastserve", "sagesched"])
def test_shared_batchstate_matches_per_node_fanout(policy):
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 150, rps=18.0, seed=11)
        pred_a = core.SemanticHistoryPredictor()
        pred_b = core.SemanticHistoryPredictor()
        shared = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy(policy),
                                         predictor=pred_a), 3)
        fanout = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy(policy),
                                         predictor=pred_b), 3,
            shared_state=False)
        assert _metric_key(shared) == _metric_key(fanout)
        assert shared.requests_per_node == fanout.requests_per_node
        return _metric_key(shared), shared.requests_per_node

    _both(scenario)


def test_object_backend_matches_numpy_in_cluster():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 80, rps=15.0, seed=3)
        runs = {}
        for backend in ("object", "numpy"):
            pred = core.SemanticHistoryPredictor()
            runs[backend] = sim.simulate_cluster(
                reqs, lambda: core.Scheduler(
                    policy=core.make_policy("sagesched"), predictor=pred,
                    priority_backend=backend), 2)
        assert _metric_key(runs["object"]) == _metric_key(runs["numpy"])
        return _metric_key(runs["numpy"])

    _both(scenario)


def test_single_node_cluster_equals_standalone_simulate():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 90, rps=12.0, seed=5)
        cluster = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy("sagesched")),
            1)
        standalone = sim.simulate(reqs, core.Scheduler(
            policy=core.make_policy("sagesched")))
        want = sorted((m.request_id, m.ttft, m.ttlt)
                      for m in standalone.metrics)
        got = sorted((m.request_id, m.ttft, m.ttlt) for m in cluster.metrics)
        assert got == want
        return got

    _both(scenario)


def test_cluster_factory_scheduler_is_used():
    for sim, core in PKGS:
        sched = core.Scheduler(policy=core.make_policy("fcfs"))
        cs = sim.ClusterScheduler(sched, n_nodes=2)
        assert cs.scheduler is sched


@pytest.mark.parametrize("backend", ["object", "numpy"])
def test_order_node_masked(backend):
    def scenario(sim, core):
        sched = core.Scheduler(policy=core.make_policy("sagesched"),
                               priority_backend=backend)
        rng = np.random.default_rng(0)
        for i in range(30):
            sched.admit(f"r{i}", f"prompt about topic {i % 5}",
                        int(rng.integers(16, 512)), arrival=float(i),
                        node_id=i % 3)
        full = sched.order()
        masked = []
        for nid in range(3):
            masked.append(sched.order(node_id=nid))
            assert masked[-1] == [r for r in full if int(r[1:]) % 3 == nid]
        sched.assign_node("r0", 2)
        assert "r0" in sched.order(node_id=2)
        assert "r0" not in sched.order(node_id=0)
        return full, masked, sched.order(node_id=2)

    _both(scenario)


def test_outstanding_by_node_batched_matches_object():
    def scenario(sim, core):
        outs = []
        for backend in ("object", "numpy"):
            sched = core.Scheduler(policy=core.make_policy("sagesched"),
                                   priority_backend=backend)
            for i in range(20):
                sched.admit(f"r{i}", f"p{i % 4}", 64 + i, arrival=float(i),
                            node_id=i % 4)
            outs.append(sched.outstanding_by_node(4))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-12)
        assert (outs[0] > 0).all()
        return [o.tolist() for o in outs]

    _both(scenario)


def test_jsow_router_matches_seed_bucketing():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 60, rps=25.0, seed=2)
        router = sim.JoinShortestWorkRouter(3)
        got = [router.route(r)
               for r in sorted(reqs, key=lambda r: r.arrival)]
        outstanding = np.zeros(3)
        last_t = 0.0
        want = []
        for r in sorted(reqs, key=lambda x: x.arrival):
            outstanding = np.maximum(0.0, outstanding
                                     - (r.arrival - last_t) * 2000.0)
            last_t = r.arrival
            n = int(np.argmin(outstanding))
            want.append(n)
            outstanding[n] += r.input_len + 2.0 * 256
        assert got == want
        return got

    _both(scenario)


def test_cost_router_prefers_node_with_headroom():
    def scenario(sim, core):
        pred = core.SemanticHistoryPredictor()
        spec = sim.NodeSpec()
        router = sim.CostAwareRouter(2, pred, spec=spec)
        cap = spec.kv_capacity_tokens
        router.kv[0].allocate("blocker", int(cap * 0.99))
        r = _req(sim, 0, arrival=0.0, input_len=2048, output_len=512)
        node = router.route(r)
        assert node == 1
        router.on_complete(r.request_id, 1)
        assert router.kv[1].used_tokens == 0
        assert router.outstanding[1] == 0.0
        return node, router.outstanding.tolist()

    _both(scenario)


def test_cost_router_prefers_less_predicted_work():
    def scenario(sim, core):
        pred = core.SemanticHistoryPredictor()
        for i in range(50):
            pred.observe(f"write a long story {i}", 32, 2000)
            pred.observe(f"short answer {i}", 32, 8)
        router = sim.CostAwareRouter(2, pred)
        long_req = _req(sim, 0, 0.0, input_len=32,
                        prompt="write a long story now")
        short_req = _req(sim, 1, 0.0, input_len=32,
                         prompt="short answer please")
        n_long = router.route(long_req)
        n_s1 = router.route(short_req)
        assert n_s1 == 1 - n_long
        n_s2 = router.route(_req(sim, 2, 0.0, input_len=32,
                                 prompt="short answer again"))
        assert n_s2 == 1 - n_long
        before = router.outstanding.tolist()
        router.on_complete(long_req.request_id, n_long)
        assert router.outstanding[n_long] == pytest.approx(0.0)
        return n_long, n_s1, n_s2, before, router.outstanding.tolist()

    _both(scenario)


def test_cost_router_saturated_picks_least_overcommitted():
    def scenario(sim, core):
        router = sim.CostAwareRouter(2, core.SemanticHistoryPredictor())
        cap = router.kv[0].capacity_tokens
        router.kv[0].allocate("b0", cap)
        router.kv[1].allocate("b1", int(cap * 0.98))
        node = router.route(_req(sim, 0, 0.0, input_len=4096,
                                 output_len=2048))
        assert node == 1
        return node

    _both(scenario)


def test_cost_router_saturated_spreads_by_outstanding_work():
    def scenario(sim, core):
        router = sim.CostAwareRouter(2, core.SemanticHistoryPredictor())
        cap = router.kv[0].capacity_tokens
        router.kv[0].allocate("b0", int(cap * 0.96))
        router.kv[1].allocate("b1", int(cap * 0.99))
        router.outstanding[0] = 1e9
        router.outstanding[1] = 1.0
        node = router.route(_req(sim, 0, 0.0, input_len=4096,
                                 output_len=2048))
        assert node == 1
        return node, router.outstanding.tolist()

    _both(scenario)


def test_cost_router_survives_deep_backlog():
    def scenario(sim, core):
        spec = sim.NodeSpec()
        router = sim.CostAwareRouter(2, core.SemanticHistoryPredictor(),
                                     spec=spec)
        n = 2 * spec.max_batch + 8
        nodes = [router.route(_req(sim, i, arrival=0.0, input_len=64))
                 for i in range(n)]
        assert int(router.outstanding.sum()) > 0
        before = router.outstanding.tolist()
        for i in range(n):
            router.on_complete(f"r{i:04d}", i % 2)
        return nodes, before, router.outstanding.tolist()

    _both(scenario)


def test_cost_router_hands_prediction_to_admit():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 40, rps=20.0, seed=13)
        pred = core.SemanticHistoryPredictor()
        holder = []

        def factory():
            s = core.Scheduler(policy=core.make_policy("sagesched"),
                               predictor=pred)
            holder.append(s)
            return s

        res = sim.simulate_cluster(reqs, factory, 2, router="cost")
        assert holder[0].stats["predictions"] == 0
        return _metric_key(res)

    _both(scenario)


def test_cost_router_end_to_end_smoke():
    def scenario(sim, core):
        reqs = sim.generate_workload(_profiles(sim), 100, rps=20.0, seed=9)
        res = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy("sagesched")),
            3, router="cost")
        assert len(res.metrics) == 100
        assert res.router == "cost"
        assert sum(res.requests_per_node) == 100
        assert all(np.isfinite(m.ttlt) for m in res.metrics)
        return _metric_key(res), res.requests_per_node, res.mean_ttlt

    _both(scenario)


def test_make_router_rejects_unknown():
    for sim, _ in PKGS:
        with pytest.raises(KeyError):
            sim.make_router("nope", 2)
    assert port_sim.ROUTER_NAMES == ref_sim.ROUTER_NAMES


def test_simultaneous_arrivals_are_routed_in_input_order():
    def scenario(sim, core):
        reqs = [_req(sim, i, arrival=1.0) for i in range(6)]
        runs = [sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy("fcfs")), 3)
            for _ in range(2)]
        by_node = {m.request_id: m.node_id for m in runs[0].metrics}
        assert [by_node[f"r{i:04d}"] for i in range(6)] == [0, 1, 2, 0, 1, 2]
        assert _metric_key(runs[0]) == _metric_key(runs[1])
        assert len(runs[0].metrics) == 6
        return _metric_key(runs[0])

    _both(scenario)


def test_event_loop_routes_against_live_state():
    def scenario(sim, core):
        reqs = [_req(sim, 0, 0.0, output_len=8),
                _req(sim, 1, 50.0, output_len=8),
                _req(sim, 2, 50.0 + 1e-9, output_len=8)]
        res = sim.simulate_cluster(
            reqs, lambda: core.Scheduler(policy=core.make_policy("sagesched")),
            2)
        assert sorted(m.request_id for m in res.metrics) == \
            ["r0000", "r0001", "r0002"]
        for m in res.metrics:
            assert m.ttlt < 10.0
        return _metric_key(res)

    _both(scenario)


def test_measure_overhead_drives_batched_path():
    def scenario(sim, core):
        o = sim.measure_scheduler_overhead(4, n_probe=8, history_size=1000,
                                           queue_depth=200)
        assert o["n_nodes"] == 4
        assert o["queue_depth"] >= 8
        assert 0 < o["schedule_ms"] < 1000
        return _overhead_structure(o, "numpy")

    _both(scenario)


def test_measure_overhead_object_backend_still_works():
    def scenario(sim, core):
        o = sim.measure_scheduler_overhead(1, n_probe=4, history_size=500,
                                           queue_depth=100, backend="object")
        return _overhead_structure(o, "object")

    _both(scenario)


def test_exports_match_reference():
    """The port exports the reference's simulator list (and the session
    generator beside it)."""
    assert set(ref_sim.__all__) <= set(port_sim.__all__)
    assert set(port_sim.__all__) - set(ref_sim.__all__) == \
        {"generate_session_workload"}


@pytest.mark.parametrize("shared", [True, False])
def test_cluster_capacity_eviction_through_node_view(shared):
    """A node whose KV fills evicts through ``NodeSchedulerView``.  The
    reference's view has no ``eviction_order`` and raises there; the
    port's delegates to the scheduler (explicit ids, no node mask).  Held
    to the port's own oracles: every request finishes, nodes evict, a
    one-node cluster equals the standalone simulator, and the shared
    state equals the per-node fanout."""
    spec = port_sim.NodeSpec(hbm_bytes=70e9, weight_bytes=64e9)
    reqs = port_sim.generate_workload(_profiles(port_sim), 60, rps=20.0,
                                      seed=6)
    ref_reqs = ref_sim.generate_workload(_profiles(ref_sim), 60, rps=20.0,
                                         seed=6)
    with pytest.raises(AttributeError, match="eviction_order"):
        ref_sim.simulate_cluster(
            ref_reqs, lambda: ref_core.Scheduler(
                policy=ref_core.make_policy("sagesched")), 1, spec,
            shared_state=shared)

    def factory():
        return port_core.Scheduler(policy=port_core.make_policy("sagesched"))

    one = port_sim.simulate_cluster(reqs, factory, 1, spec,
                                    shared_state=shared)
    alone = port_sim.simulate(reqs, factory(), spec)
    assert one.node_results[0].n_evictions == alone.n_evictions > 0
    assert sorted((m.request_id, m.ttft, m.ttlt, m.n_preemptions)
                  for m in one.metrics) == \
        sorted((m.request_id, m.ttft, m.ttlt, m.n_preemptions)
               for m in alone.metrics)
    pred_a = port_core.SemanticHistoryPredictor()
    pred_b = port_core.SemanticHistoryPredictor()
    two = [port_sim.simulate_cluster(
        reqs, lambda: port_core.Scheduler(
            policy=port_core.make_policy("sagesched"), predictor=p), 2,
        spec, shared_state=s) for p, s in ((pred_a, True), (pred_b, False))]
    assert _metric_key(two[0]) == _metric_key(two[1])
    assert len(two[0].metrics) == 60
    assert sum(r.n_evictions for r in two[0].node_results) > 0
