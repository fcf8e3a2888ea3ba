"""The readers of the program's spans (``servebench/spans.py``): their
arithmetic on synthetic spans, the idle-gap labels at any depth (and the
same as ``trace.label_gaps`` on the harness's own spans); small CPU runs
of ``servebench/spantrace.py`` that read the window's spans with the
recorder on and record none with it off; and the benchmark's own traced
run, which never switches the recorder on and reports every old metric,
with or without a recorder in the program."""

import random
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CELLS = ("qwen2-1.5b.mix-poisson", "olmoe-1b-7b.mix-backlog")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU runs beside other test workers: one thread each."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _empty_recorder():
    from repro_torch import tracing
    tracing.disable()
    tracing.drain()
    yield tracing
    tracing.disable()
    tracing.drain()


def test_readers_on_synthetic_spans():
    from repro_torch.tracing import Span

    from servebench import spans as S
    ms = 1_000_000
    sp = [Span("engine.submit", 0, 3 * ms, -1, None),
          Span("sched.admit_batch", 0, 3 * ms, 0, None),
          Span("sched.predict", 0, 2 * ms, 1, None),
          Span("engine.step", 10 * ms, 30 * ms, -1, None),
          Span("engine.preempt", 11 * ms, 15 * ms, 3, "r1"),
          Span("kv.swap_out", 11 * ms, 14 * ms, 4, "r1"),
          Span("engine.decode", 16 * ms, 29 * ms, 3, None),
          Span("runner.stage", 16 * ms, 17 * ms, 6, None),
          Span("runner.wait", 17 * ms, 25 * ms, 6, None),
          Span("engine.finish", 26 * ms, 28 * ms, 6, "r0"),
          Span("sched.observe", 26 * ms, 27 * ms, 9, "r0"),
          Span("engine.step", 40 * ms, 50 * ms, -1, None),
          Span("kv.swap_in", 41 * ms, 43 * ms, 11, "r1"),
          Span("runner.wait", 44 * ms, 49 * ms, 11, None)]
    # step 1: 20 ms less 3 (swap) and 8 (wait); step 2: 10 less 2 and 5
    assert S.step_host_ms(sp) == pytest.approx((9 + 3) / 2)
    assert S.swap_ms_per_step(sp) == pytest.approx((3 + 2) / 2)
    # predict 2 ms + observe 1 ms over 3 requests
    assert S.predict_ms_per_req(sp, 3) == pytest.approx(1.0)
    assert S.predict_ms_per_req(sp, 0) is None
    # self times a step: the first step's 20 ms less its three children
    own = S.self_ms_per_step(sp)
    assert own["engine.step"] == pytest.approx(((20 - 4 - 13) + 10 - 7) / 2)
    assert own["runner.wait"] == pytest.approx((8 + 5) / 2)
    assert S.step_host_ms(sp[:3]) is None
    assert S.swap_ms_per_step([]) is None


def _harness_spans(rng):
    """Spans as the harness records them: ``step`` (with ``order`` inside
    it), ``submit`` (with ``admit_batch`` inside), ``idle_wait``, one
    after another with random lengths and pauses."""
    spans, t = [], 0.0
    for _ in range(rng.randint(1, 60)):
        t += rng.uniform(0.0, 2.0)
        kind = rng.choice(["step", "submit", "idle_wait"])
        length = rng.uniform(0.5, 20.0)
        spans.append((kind, t, t + length))
        inner = {"step": "order", "submit": "admit_batch"}.get(kind)
        if inner and rng.random() < 0.7:
            a = t + rng.uniform(0.0, length / 2)
            spans.append((inner, a, a + rng.uniform(0.0, t + length - a)))
        t += length
    rng.shuffle(spans)
    return spans, t


def test_labels_equal_the_old_ones_on_harness_spans():
    from servebench import spans as S
    from servebench import trace
    rng = random.Random(20261019)
    for _ in range(300):
        spans, t_end = _harness_spans(rng)
        gaps = []
        for _ in range(rng.randint(0, 40)):
            a = rng.uniform(-2.0, t_end + 2.0)
            gaps.append((a, a + rng.uniform(0.0, 3.0)))
        assert S.label_gaps(gaps, spans) == trace.label_gaps(gaps, spans)


def test_labels_are_right_at_any_depth():
    """A step with dozens of closed children before a gap, and a chain
    nested twelve deep: the innermost span holding the middle wins, where
    a look-back over the last few spans finds none."""
    from servebench import spans as S
    children = [(f"c{i}", 1.0 + i, 1.5 + i) for i in range(40)]
    spans = [("engine.step", 0.0, 100.0)] + children
    assert S.label_gaps([(60.0, 62.0)], spans) == [("engine.step", 2.0)]
    assert S.label_gaps([(3.1, 3.3)], spans)[0][0] == "c2"
    chain = [(f"d{i}", float(i), 100.0 - i) for i in range(12)]
    assert S.label_gaps([(49.0, 51.0), (0.5, 0.7), (200.0, 201.0)],
                        chain + children) == [
        ("d11", 2.0), ("d0", pytest.approx(0.2)), ("harness", 1.0)]
    idle = S.idle_by_span([(49.0, 51.0), (60.0, 61.0), (300.0, 301.0)],
                          chain)
    assert idle == {"d11": pytest.approx(3e-6), "harness": 1e-6}


def _span_run(workload, recorder):
    from servebench.smallrun import SEED, small_cell
    from servebench.spantrace import trace_cell
    cfg, mix, mc = small_cell(workload)
    return trace_cell(workload, SEED, 2.0, recorder, device="cpu",
                      cfg_file=cfg, mix=mix, model_config=mc)


@pytest.mark.parametrize("workload", CELLS)
def test_a_span_run_reads_the_window(workload, _empty_recorder):
    out = _span_run(workload, recorder=True)
    win, traced = out["window"], out["traced"]
    assert win["steps"] == out["window_steps"] > 0
    for name in ("step_host_ms", "swap_ms_per_step", "predict_ms_per_req"):
        assert win[name] >= 0.0
    assert win["step_host_ms"] <= out["step_ms"]
    assert win["self_ms_per_step"]["engine.step"] >= 0.0
    assert traced["steps"] > 0 and traced["clock"]["pairs"] > 0
    assert "engine.step" in traced["self_ms_per_step"]
    # the CPU runs no device operation: the whole span is idle, labelled
    assert sum(traced["idle_by_span"].values()) \
        == pytest.approx(traced["idle_s"])
    assert set(traced["idle_by_span"]) & {"engine.step", "engine.decode",
                                          "decode.book", "runner.stage"}
    assert not _empty_recorder.RECORDER.on
    assert _empty_recorder.drain() == []


def test_a_span_run_with_the_recorder_off_records_nothing(_empty_recorder):
    out = _span_run("olmoe-1b-7b.mix-backlog", recorder=False)
    assert out["window_steps"] > 0 and out["step_ms"] > 0
    assert "window" not in out and "traced" not in out
    assert _empty_recorder.drain() == []


def _traced_run(workload):
    from servebench import run as R
    from servebench.smallrun import SEED, small_cell
    cfg, mix, mc = small_cell(workload)
    result, _ = R.execute(workload, SEED, 2.0, True, device="cpu",
                          cfg_file=cfg, mix=mix, model_config=mc)
    assert result["correct"], result["checks"]
    return set(result["metrics"])


def _host_metrics(workload):
    """The cell's per-layer metrics less those of the device trace, which
    a CPU run does not give."""
    from servebench import run as R
    bench, _, _, _ = R.load_cell(workload)
    return {m["name"] for m in R.cell_metrics(bench, workload, True)
            if m["source"] != "device_trace"}


def test_the_benchmark_run_never_switches_the_recorder_on(monkeypatch,
                                                          _empty_recorder):
    def refuse():
        raise AssertionError("the benchmark's run switched the recorder on")
    monkeypatch.setattr(_empty_recorder, "enable", refuse)
    w = "olmoe-1b-7b.mix-backlog"
    assert _traced_run(w) == _host_metrics(w)
    assert _empty_recorder.drain() == []


def test_a_program_without_a_recorder_reports_the_old_metrics(monkeypatch):
    """As on an older port: ``repro_torch.tracing`` cannot be imported, and
    the traced run reports the same metrics."""
    import repro_torch
    import repro_torch.serving.engine  # noqa: F401  (imported before)
    w = "qwen2-1.5b.mix-poisson"
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    assert _traced_run(w) == _host_metrics(w)
