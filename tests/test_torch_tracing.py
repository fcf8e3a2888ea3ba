"""The port's span recorder (``repro_torch.tracing``) and the spans the
engine, its step runners, the scheduler and the swap plane open: off it
records and allocates nothing; on, spans nest with their parents and
request ids, on the profiler's clock; a small CPU drive gives one
``engine.step`` a step, one ``engine.prefill`` a chunk, swap byte counts
equal to the payloads', and the same tokens as with the recorder off."""

import collections
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import core, serving, tracing
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.tracing import Span


@pytest.fixture(autouse=True)
def _empty_recorder():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with the recorder off")
    monkeypatch.setattr(time, "time_ns", no_clock)
    assert tracing.span("a.b") is tracing.span("c.d", "r0")
    tracemalloc.start()
    try:
        for i in range(1000):
            with tracing.span("engine.step"):
                with tracing.span("engine.admit", "r1"):
                    pass
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(True, tracing.__file__)])
    assert mine.statistics("filename") == []
    monkeypatch.undo()
    assert tracing.drain() == []


def test_nesting_gives_parents_and_request_ids():
    tracing.enable()
    with tracing.span("engine.step"):
        with tracing.span("engine.preempt", "r7"):
            with tracing.span("kv.swap_out"):
                pass
        with tracing.span("engine.prefill", "r8"):
            with tracing.span("runner.stage"):
                pass
            with tracing.span("runner.wait", "other"):
                pass
    with tracing.span("engine.submit"):
        pass
    tracing.disable()
    got = [(s.name, s.parent, s.rid) for s in tracing.drain()]
    assert got == [("engine.step", -1, None), ("engine.preempt", 0, "r7"),
                   ("kv.swap_out", 1, "r7"), ("engine.prefill", 0, "r8"),
                   ("runner.stage", 3, "r8"), ("runner.wait", 3, "other"),
                   ("engine.submit", -1, None)]


def test_drain_refuses_an_open_span():
    tracing.enable()
    with tracing.span("engine.step"):
        with pytest.raises(RuntimeError):
            tracing.drain()
    assert [s.name for s in tracing.drain()] == ["engine.step"]


def test_self_time_is_duration_less_the_children_cover():
    spans = [Span("engine.step", 0, 100, -1, None),
             Span("engine.select", 5, 25, 0, None),
             Span("sched.order", 10, 20, 1, None),
             Span("engine.decode", 30, 90, 0, None),
             Span("runner.wait", 40, 80, 3, None)]
    assert tracing.self_ns(spans) == [100 - 20 - 60, 20 - 10, 10,
                                      60 - 40, 40]
    tracing.enable()
    with tracing.span("engine.step"):
        with tracing.span("engine.select"):
            time.sleep(0.002)
        time.sleep(0.001)
    tracing.disable()
    step, select = tracing.drain()
    own = tracing.self_ns([step, select])
    assert own[0] == (step.end_ns - step.start_ns) \
        - (select.end_ns - select.start_ns)
    assert own[0] >= 1_000_000 and own[1] >= 2_000_000


def _kineto_start_ns(event) -> int:
    if hasattr(event, "start_ns"):
        return event.start_ns()
    return int(event.start_us() * 1000)


def test_a_span_starts_on_the_profiler_clock():
    """A span starts within 1 ms of a ``record_function`` range opened just
    before it, on the kineto timeline (after a first pair, which also pays
    both calls' first-use costs)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with record_function("probe"):
                with tracing.span("engine.step"):
                    with tracing.span("engine.select"):
                        torch.ones(8).sum()
    tracing.disable()
    spans = tracing.drain()
    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == 4 and len(spans) == 8
    probes = sorted(_kineto_start_ns(e)
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe")
    assert len(probes) == 4
    for p, s in list(zip(probes, steps))[1:]:
        assert abs(s.start_ns - p) < 1_000_000


def test_the_profiler_alone_switches_nothing_on():
    """Profiling the port records no span: the recorder follows
    ``enable()`` alone, so a profiled run holds no spans in memory."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("engine.step"):
            with tracing.span("engine.select"):
                torch.ones(8).sum()
        _, steps, _, _ = _drive("llama3.2-1b", recorder=False)
    assert steps > 0
    assert not tracing.RECORDER.on
    assert tracing.drain() == []


# ------------------------------------------------------------ engine drive

def _drive(arch: str, recorder: bool):
    """The reduced ``arch`` under SageSched with an oracle predictor, two
    slots and a KV budget small enough to swap, at T 0.6; returns the
    engine, the steps taken, the streams and the payloads' bytes."""
    cfg = get_config(arch, reduced=True)
    o = core.OraclePredictor()
    for i in range(4):
        o.register(f"p{i}", core.LengthDistribution(np.array([6 + 3 * i]),
                                                    np.array([1.0])))
    eng = serving.ServingEngine(
        model=build_model(cfg),
        scheduler=core.Scheduler(policy=core.make_policy("sagesched"),
                                 predictor=o),
        n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
        preemption_mode="swap", prefill_chunk=8, max_tokens_per_step=12,
        seed=0, device="cpu")
    gathered = [0]
    real = eng._gather_payload

    def gather(r, blocks):
        payload = real(r, blocks)
        for k in ("k", "v"):
            if k in payload:
                gathered[0] += payload[k].nbytes
        for t in payload.get("ssm", {}).values():
            gathered[0] += t.nbytes
        return payload
    eng._gather_payload = gather
    rng = np.random.default_rng(7)
    reqs = [serving.ServeRequest(
        f"r{i}", f"p{i}",
        [int(t) for t in rng.integers(3, cfg.vocab_size,
                                      int(rng.integers(6, 19)))],
        max_new_tokens=6 + 3 * i, temperature=0.6, eos_token=1)
        for i in range(4)]
    if recorder:
        tracing.enable()
    eng.submit_batch(reqs)
    steps = 0
    while eng.has_work and steps < 4000:
        eng.step()
        steps += 1
    tracing.disable()
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    return eng, steps, [list(r.output_tokens) for r in reqs], gathered[0]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_engine_drive_spans_and_swap_bytes(arch):
    eng0, steps0, toks0, _ = _drive(arch, recorder=False)
    assert tracing.drain() == []
    eng, steps, toks, gathered = _drive(arch, recorder=True)
    spans = tracing.drain()
    assert toks == toks0 and steps == steps0
    names = collections.Counter(s.name for s in spans)
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["engine.submit"] \
        + ["engine.step"] * steps
    assert names["engine.prefill"] == eng.metrics.prefill_chunks
    assert names["engine.preempt"] == eng.metrics.preemptions > 0
    assert names["kv.swap_out"] == eng.metrics.swap_outs > 0
    assert names["kv.swap_in"] == eng.metrics.swap_ins
    assert names["engine.finish"] == names["sched.complete"] == 4
    for s in spans:
        if s.name in ("kv.swap_out", "kv.swap_in", "engine.prefill",
                      "engine.finish"):
            assert s.rid in {"r0", "r1", "r2", "r3"}
        if s.name == "kv.swap_out":
            assert spans[s.parent].name == "engine.preempt"
            assert spans[s.parent].rid == s.rid
        if s.name == "runner.stage" and spans[s.parent].name \
                == "engine.prefill":
            assert s.rid == spans[s.parent].rid
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    m = eng.metrics
    assert m.swapped_out_bytes == gathered > 0
    # every swapped-out request came back: the same bytes went both ways
    assert m.swap_ins == m.swap_outs
    assert m.swapped_in_bytes == m.swapped_out_bytes
    assert eng0.metrics.swapped_out_bytes == m.swapped_out_bytes
