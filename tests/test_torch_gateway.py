"""The port's Gateway (repro_torch.serving.gateway) over the port's engine,
held to the reference's Gateway over the reference's engine: each of
tests/test_gateway.py's scenarios runs on both packages with the same
inputs and weights (tests/torch_parity.py), asserts the reference test's
own claims on each, and holds verdicts, dispositions and reasons, request
states, streams and engine counters equal.

The requests are greedy, and the bounded-queue scenario also runs at the
paper's temperature 0.6 (the reference's tests' default), where the fused
step draws the reference's threefry categorical (ROADMAP, Port
conventions, Sampling).
"""

import functools

import numpy as np
import pytest
import torch

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
    kw.setdefault("clock", testing.VirtualClock())
    return engine(pkg, ARCH, scheduler=sched, n_slots=n_slots,
                  max_seq_len=96, seed=0, **kw)


def _req(pkg, i, prompt="p", max_new=6, n_prompt=6, temperature=0.0,
         **kw):
    rng = np.random.default_rng(i)
    toks = [int(t) for t in rng.integers(3, VOCAB, n_prompt)]
    return pkg[1].ServeRequest(request_id=f"g{i}", prompt=prompt,
                               prompt_tokens=toks, max_new_tokens=max_new,
                               eos_token=0, temperature=temperature, **kw)


def _record(gw, eng, reqs, verdicts=()):
    return ([v.value for v in verdicts], dict(gw.dispositions),
            request_record(reqs), counters(eng))


def _both(scenario):
    """Run ``scenario(pkg)`` on the port and on the reference; their
    records must be equal."""
    got, want = scenario(PORT), scenario(REF)
    assert got == want


def _bounded_queues(pkg, temperature=0.0):
    _, serving, testing, _, _ = pkg
    V = serving.Verdict
    eng = _engine(pkg, n_slots=1)
    gw = serving.Gateway(eng, serving.GatewayConfig(
        max_inflight=2, max_queue_per_tenant=2, max_total_queue=2,
        max_retries=0, shed_policy="tail"))
    reqs = [_req(pkg, i, temperature=temperature) for i in range(6)]
    verdicts = gw.offer_batch(reqs)
    assert verdicts == [V.ACCEPT, V.ACCEPT, V.QUEUE, V.QUEUE, V.SHED,
                        V.SHED]
    assert eng.metrics.shed == 2
    gw.run_until_drained(max_steps=2000)
    gw.assert_all_terminal()
    kinds = sorted(k for k, _ in gw.dispositions.values())
    assert kinds == ["FINISHED"] * 4 + ["SHED"] * 2
    assert all(reason == "queue_full" for k, reason in
               gw.dispositions.values() if k == "SHED")
    testing.assert_engine_quiesced(eng)
    return _record(gw, eng, reqs, verdicts)


def test_gateway_verdicts_and_bounded_queues():
    _both(_bounded_queues)


def test_gateway_sampled_at_the_paper_temperature():
    """The bounded-queue scenario with every request at temperature 0.6:
    the records are the reference's, and the streams are not the greedy
    ones."""
    _both(functools.partial(_bounded_queues, temperature=0.6))
    assert _bounded_queues(PORT, 0.6)[2] != _bounded_queues(PORT)[2]


def test_gateway_round_robin_protects_tenants():
    """One tenant's flood cannot take another tenant's queue space, and
    the round-robin pump serves the minority tenant early."""
    def scenario(pkg):
        _, serving, _, _, _ = pkg
        V = serving.Verdict
        eng = _engine(pkg, n_slots=1)
        gw = serving.Gateway(eng, serving.GatewayConfig(
            max_inflight=1, max_queue_per_tenant=4, max_total_queue=16,
            max_retries=0, shed_policy="tail"))
        flood = [_req(pkg, i, tenant="a") for i in range(6)]
        va = gw.offer_batch(flood)
        assert va == [V.ACCEPT] + [V.QUEUE] * 4 + [V.SHED]
        minority = _req(pkg, 10, tenant="b")
        assert gw.offer(minority) == V.QUEUE
        finish_order = []
        while not gw.drained:
            gw.step()
            for r in flood + [minority]:
                if r.state == serving.RequestState.FINISHED \
                        and r.request_id not in finish_order:
                    finish_order.append(r.request_id)
        assert finish_order.index("g10") <= 2
        gw.assert_all_terminal()
        return _record(gw, eng, flood + [minority], va) + (finish_order,)

    _both(scenario)


def test_gateway_cost_shedding_drops_widest_tail():
    """Under pressure the cost policy sheds the request whose predicted
    cost upper quantile is worst."""
    def scenario(pkg):
        core, serving, _, _, _ = pkg
        V = serving.Verdict
        o = core.OraclePredictor()
        o.register("cheap", core.LengthDistribution(np.array([4]),
                                                    np.array([1.0])))
        o.register("wide", core.LengthDistribution(np.array([4, 400]),
                                                   np.array([0.5, 0.5])))
        eng = _engine(pkg, n_slots=1, predictor=o, policy="ssjf")
        gw = serving.Gateway(eng, serving.GatewayConfig(
            max_inflight=1, max_queue_per_tenant=1, max_total_queue=1,
            max_retries=0, shed_policy="cost", shed_quantile=0.9))
        reqs = [_req(pkg, 0, prompt="cheap"),
                _req(pkg, 1, prompt="wide", max_new=8),
                _req(pkg, 2, prompt="cheap")]
        verdicts = [gw.offer(r) for r in reqs]
        assert verdicts == [V.ACCEPT, V.QUEUE, V.QUEUE]
        assert gw.dispositions["g1"] == ("SHED", "displaced_by_cheaper")
        assert eng.metrics.shed == 1
        gw.run_until_drained(max_steps=2000)
        gw.assert_all_terminal()
        assert gw.dispositions["g0"][0] == "FINISHED"
        assert gw.dispositions["g2"][0] == "FINISHED"
        return _record(gw, eng, reqs, verdicts)

    _both(scenario)


def test_gateway_degraded_mode_falls_back_to_static_limits():
    """Predictor outage: the scheduler takes the flat prior, the gateway
    sheds FCFS tail-drop under the static in-flight limit, and every
    request terminates with a reason."""
    def scenario(pkg):
        core, serving, testing, _, _ = pkg
        V = serving.Verdict
        flaky = testing.FlakyPredictor(core.SemanticHistoryPredictor(),
                                       mode="outage")
        eng = _engine(pkg, n_slots=2, predictor=flaky, policy="sagesched")
        gw = serving.Gateway(eng, serving.GatewayConfig(
            max_inflight=8, degraded_max_inflight=2, max_queue_per_tenant=4,
            max_total_queue=4, max_retries=0, shed_policy="cost"))
        reqs = [_req(pkg, i) for i in range(8)]
        verdicts = gw.offer_batch(reqs)
        assert gw.degraded and eng.scheduler.degraded
        assert eng.scheduler.stats["prediction_failures"] > 0
        assert verdicts.count(V.ACCEPT) == 2
        assert verdicts.count(V.QUEUE) == 4
        assert verdicts.count(V.SHED) == 2
        gw.run_until_drained(max_steps=4000)
        gw.assert_all_terminal()
        testing.assert_engine_quiesced(eng)
        return _record(gw, eng, reqs, verdicts) + (
            eng.scheduler.stats["prediction_failures"],)

    _both(scenario)


def test_gateway_deadline_aborts_release_every_block():
    def scenario(pkg):
        _, serving, testing, _, _ = pkg
        V = serving.Verdict
        clock = testing.VirtualClock()
        eng = _engine(pkg, n_slots=2, clock=clock)
        gw = serving.Gateway(eng, serving.GatewayConfig(max_inflight=2))
        r0 = _req(pkg, 0, max_new=64, ttlt_deadline_s=0.5)
        r1 = _req(pkg, 1, max_new=64, ttft_deadline_s=0.25)
        verdicts = gw.offer_batch([r0, r1])
        assert verdicts == [V.ACCEPT, V.ACCEPT]
        clock.advance(0.3)
        gw.tick()
        assert r1.state == serving.RequestState.ABORTED
        assert r1.finish_reason == "ttft_deadline"
        gw.step()
        clock.advance(0.7)
        gw.tick()
        assert r0.state == serving.RequestState.ABORTED
        assert r0.finish_reason == "ttlt_deadline"
        assert eng.metrics.timeout_aborts == 2
        assert eng.metrics.wasted_tokens == r0.generated + r1.generated
        eng.kv.assert_conserved()
        assert eng.kv.free_slots == 2 and eng.kv.used_tokens == 0
        gw.assert_all_terminal()
        s = eng.metrics.summary([r0, r1])
        assert s["timeout_aborts"] == 2
        assert s["goodput_tokens"] == eng.metrics.decode_tokens \
            - s["wasted_tokens"]
        return _record(gw, eng, [r0, r1], verdicts) + (
            {k: s[k] for k in ("timeout_aborts", "goodput_tokens",
                               "wasted_tokens")},)

    _both(scenario)


def test_gateway_queued_deadline_shed_without_engine_work():
    def scenario(pkg):
        _, serving, testing, _, _ = pkg
        V = serving.Verdict
        clock = testing.VirtualClock(start=5.0)
        eng = _engine(pkg, n_slots=1, clock=clock)
        gw = serving.Gateway(eng, serving.GatewayConfig(max_inflight=1))
        r0 = _req(pkg, 0, max_new=32)
        r1 = _req(pkg, 1, max_new=8, arrival=clock(), ttlt_deadline_s=0.2)
        verdicts = gw.offer_batch([r0, r1])
        assert verdicts == [V.ACCEPT, V.QUEUE]
        clock.advance(1.0)
        gw.tick()
        assert gw.dispositions["g1"] == ("SHED", "deadline")
        assert r1.state == serving.RequestState.SHED
        gw.run_until_drained(max_steps=2000)
        gw.assert_all_terminal()
        return _record(gw, eng, [r0, r1], verdicts)

    _both(scenario)


def test_gateway_retry_backoff_eventually_admits():
    """A shed request retries with exponential backoff and is admitted
    once pressure clears."""
    def scenario(pkg):
        _, serving, _, _, _ = pkg
        V = serving.Verdict
        eng = _engine(pkg, n_slots=1)
        gw = serving.Gateway(eng, serving.GatewayConfig(
            max_inflight=1, max_queue_per_tenant=0, max_total_queue=0,
            max_retries=3, retry_backoff_s=0.1, shed_policy="tail"))
        r0, r1 = _req(pkg, 0, max_new=4), _req(pkg, 1, max_new=4)
        verdicts = gw.offer_batch([r0, r1])
        assert verdicts == [V.ACCEPT, V.SHED]
        assert not gw.dispositions.get("g1")
        gw.run_until_drained(max_steps=2000)
        gw.assert_all_terminal()
        assert gw.dispositions["g1"][0] == "FINISHED"
        assert eng.metrics.retries >= 1
        assert eng.metrics.shed == 0
        return _record(gw, eng, [r0, r1], verdicts)

    _both(scenario)


def test_gateway_retry_exhaustion_is_terminal_shed():
    def scenario(pkg):
        _, serving, _, _, _ = pkg
        eng = _engine(pkg, n_slots=1)
        gw = serving.Gateway(eng, serving.GatewayConfig(
            max_inflight=1, max_queue_per_tenant=0, max_total_queue=0,
            max_retries=2, retry_backoff_s=0.05, shed_policy="tail"))
        r0 = _req(pkg, 0, max_new=64)
        r1 = _req(pkg, 1, max_new=4)
        verdicts = gw.offer_batch([r0, r1])
        clock = gw.clock
        for _ in range(8):
            clock.advance(0.5)
            gw.tick()
            if gw.dispositions.get("g1"):
                break
        assert gw.dispositions["g1"] == ("SHED", "queue_full")
        assert r1.state == serving.RequestState.SHED
        assert eng.metrics.retries == 2 and eng.metrics.shed == 1
        gw.run_until_drained(max_steps=2000)
        gw.assert_all_terminal()
        return _record(gw, eng, [r0, r1], verdicts)

    _both(scenario)


def test_gateway_duplicate_offer_rejected():
    def scenario(pkg):
        _, serving, _, _, _ = pkg
        eng = _engine(pkg, n_slots=1)
        gw = serving.Gateway(eng)
        r = _req(pkg, 0)
        verdict = gw.offer(r)
        with pytest.raises(KeyError):
            gw.offer(r)
        return verdict.value, dict(gw.dispositions), counters(eng)

    _both(scenario)
