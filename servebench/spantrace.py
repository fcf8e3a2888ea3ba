"""The program's spans in one run of a cell: where the host's time goes.

    python3 servebench/spantrace.py --workload <cell> --seed <n> \\
        --seconds <s> [--recorder on|off]

Runs the cell as ``run.py --trace 1`` does (set-up, the window, then
``harness.TRACE_SECONDS`` more of the traffic under ``torch.profiler``),
with the port's span recorder (``repro_torch.tracing``) on from the
window's open to the traced span's end (``on``, the default) or never
(``off``, the baseline of its cost), drained at the window's end and after
the traced span.  Prints, as the last line of standard output, one JSON
object:

* ``step_ms``: host ms a step of the window (as the ``step_ms`` metric),
  and ``device_idle_pct`` of the traced span (as that metric): ``on``
  against ``off`` gives what the recorder costs;
* ``window`` (``on``): the readers of ``spans.py`` over the window, where
  no profiler runs (``step_host_ms``, ``swap_ms_per_step``,
  ``predict_ms_per_req`` over the requests attempted), the spans a step,
  each span's self ms a step, and the swaps' bytes (``EngineMetrics``),
  seconds and GB/s;
* ``traced`` (``on``): the traced span's idle seconds by innermost span,
  the harness's ranges and the program's spans alike, over every gap
  (``idle_by_span``), its ten longest gaps labelled, ``clock`` (the median
  offsets in us between each program ``engine.step`` and the harness's
  ``step`` range that holds it, the device operations before and after
  the host events' range, and each device operation's start less that of
  the runtime call that launched it), ``step_self_share`` (``engine.step``'s time covered
  by no child span, over its duration) and ``graph_launch_ms_per_step``
  (host ms a step in ``cudaGraphLaunch``, which the profiler lengthens:
  so the readings above come from the window, not the traced span).

It needs a card, as ``run.py`` does; ``trace_cell`` also runs a small cell
on the CPU for the tests.  The benchmark's result line reads none of it.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402
from repro_torch import tracing  # noqa: E402

from servebench import harness  # noqa: E402
from servebench import readers  # noqa: E402
from servebench import spans as S  # noqa: E402
from servebench import trace as T  # noqa: E402


class SpanRun(harness.Run):
    """A traced ``harness.Run`` that switches the recorder on at the
    window's open, drains it at the window's end and after the traced
    span, and keeps the profiler's events and the swap byte counters at
    those three points."""

    def __init__(self, *args, recorder: bool, **kw):
        super().__init__(*args, trace=True, **kw)
        self.recorder = recorder
        self.swap_bytes: list = []       # [out, in] at open, end, traced
        self.window_spans = self.traced_spans = self.events = None
        self.leads: dict = {}

    def _bytes(self) -> list:
        m = self.engine.metrics
        return [m.swapped_out_bytes, m.swapped_in_bytes]

    def _open_window(self, start: float) -> None:
        super()._open_window(start)
        self.swap_bytes.append(self._bytes())
        if self.recorder:
            tracing.drain()
            tracing.enable()

    def _traced(self, make_send) -> None:
        """The harness's traced span, as ``harness.Run._traced`` runs it,
        between the two drains, with the events kept."""
        self.window_spans = tracing.drain() if self.recorder else []
        self.swap_bytes.append(self._bytes())
        prof = T.prepare_profiler()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.labels = True
        t0 = time.monotonic()
        prof.start_trace()
        log = harness.StepLog()
        self._loop(make_send(t0), t0 + harness.TRACE_SECONDS, log)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        prof.stop_trace()
        self.span.labels = False
        self.events = T._events(prof)
        self.leads = _device_leads(prof)
        self.win.trace = T.summarize(prof, (t0, t1))
        self.win.trace_log = log
        if self.recorder:
            self.traced_spans = tracing.drain()
            tracing.disable()
        self.swap_bytes.append(self._bytes())


def _device_leads(prof) -> dict:
    """Device start less host start (us) of each device operation and the
    runtime call that launched it (the two share a correlation id): never
    negative where kineto's device stamps share the host's base."""
    cuda = torch.autograd.DeviceType.CUDA
    host, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        c = e.correlation_id()
        if not c:
            continue
        if e.device_type() == cuda:
            dev.append((c, e.start_ns()))
        else:
            host.setdefault(c, e.start_ns())
    leads = [(t - host[c]) / 1e3 for c, t in dev if c in host]
    if not leads:
        return {"pairs": 0}
    return {"pairs": len(leads), "lead_us_min": min(leads),
            "lead_us_median": statistics.median(leads),
            "negative": sum(1 for v in leads if v < 0)}


def _offsets(harness_steps, program_steps) -> dict:
    """Median offsets (us) of each program ``engine.step`` from the harness
    ``step`` range that starts last before it: start (program minus
    harness) and end (harness minus program)."""
    hs = sorted(harness_steps, key=lambda s: s[1])
    starts = [s[1] for s in hs]
    d0, d1 = [], []
    for _, a, b in program_steps:
        j = bisect.bisect_right(starts, a) - 1
        if j < 0 or hs[j][2] < b:
            continue
        d0.append(a - hs[j][1])
        d1.append(hs[j][2] - b)
    if not d0:
        return {"pairs": 0}
    return {"pairs": len(d0), "start_us_median": statistics.median(d0),
            "end_us_median": statistics.median(d1),
            "start_us_max": max(d0)}


def _swap(spans, moved: list) -> dict:
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in S.SWAPS)
    return {"out_bytes": moved[0], "in_bytes": moved[1], "seconds": ns / 1e9,
            "GB_per_s": sum(moved) / ns if ns else None}


def window_part(run: SpanRun) -> dict:
    """The span readings of the window (recorder on, no profiler)."""
    spans, w = run.window_spans, run.win
    steps = sum(1 for s in spans if s.parent < 0 and s.name == S.STEP)
    if steps != w.n_steps:
        raise SystemExit(f"spantrace: {steps} engine.step spans in a window "
                         f"of {w.n_steps} steps: the recorder did not follow "
                         "the window")
    b0, b1 = run.swap_bytes[:2]
    return {"step_host_ms": S.step_host_ms(spans),
            "swap_ms_per_step": S.swap_ms_per_step(spans),
            "predict_ms_per_req": S.predict_ms_per_req(spans, w.attempted),
            "steps": steps, "spans_per_step": len(spans) / max(1, steps),
            "swap": _swap(spans, [b1[k] - b0[k] for k in (0, 1)]),
            "self_ms_per_step": S.self_ms_per_step(spans)}


def traced_part(run: SpanRun) -> dict:
    """The traced span's idle time by span, the clock and the
    attribution (recorder on)."""
    events, spans = run.events, run.traced_spans
    lo = min(e[2] for e in events)
    hi = lo + run.win.trace.window_s * 1e6
    ops = [(a, b) for on, name, a, b in events
           if on and name not in T.LABELS]
    _, merged = T.union_length([(max(a, lo), min(b, hi)) for a, b in ops
                                if b > lo and a < hi])
    gaps = T.idle_gaps(merged, lo, hi)
    harness_spans = [(name, a, b) for on, name, a, b in events
                     if not on and name in T.LABELS]
    program = S.events_us(spans)
    labelled = harness_spans + program
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    cpu = [(a, b) for on, _, a, b in events if not on]
    c_lo, c_hi = min(a for a, _ in cpu), max(b for _, b in cpu)
    steps = [p for p in program if p[0] == S.STEP]
    own = tracing.self_ns(spans)
    roots = [i for i, s in enumerate(spans)
             if s.parent < 0 and s.name == S.STEP]
    step_ns = sum(spans[i].end_ns - spans[i].start_ns for i in roots)
    launch_us = sum(b - a for on, name, a, b in events
                    if not on and name == "cudaGraphLaunch")
    b1, b2 = run.swap_bytes[1:]
    return {"idle_s": sum(b - a for a, b in gaps) / 1e6,
            "idle_by_span": S.idle_by_span(gaps, labelled),
            "top_gaps": [[n, s / 1e6]
                         for n, s in S.label_gaps(top, labelled)],
            "clock": {**_offsets([h for h in harness_spans
                                  if h[0] == "step"], steps),
                      "device_ops": len(ops),
                      "device_ops_before_host_events": sum(
                          1 for a, _ in ops if a < c_lo),
                      "device_ops_after_host_events": sum(
                          1 for _, b in ops if b > c_hi),
                      "launch_to_device": run.leads},
            "steps": len(roots),
            "step_self_share": sum(own[i] for i in roots) / step_ns
            if step_ns else None,
            "swap": _swap(spans, [b2[k] - b1[k] for k in (0, 1)]),
            "graph_launch_ms_per_step": launch_us / 1e3 / max(1, len(roots)),
            "self_ms_per_step": S.self_ms_per_step(spans)}


def trace_cell(workload: str, seed: int, seconds: float, recorder: bool, *,
               device: str = "cuda", cfg_file=None, mix=None,
               model_config=None) -> dict:
    """One run of the cell read as the module docstring says; the
    configuration, mix and model config may be replaced, as in
    ``run.execute``."""
    from servebench.run import load_cell
    _, _, cfg0, mix0 = load_cell(workload)
    run = SpanRun(cfg_file or cfg0, mix or mix0, seed, seconds,
                  device=device, model_config=model_config,
                  t_process=time.monotonic(), recorder=recorder)
    run.setup()
    w = run.drive()
    if run.events is None:
        raise SystemExit("spantrace: the traced span did not run through "
                         "SpanRun._traced")
    out = {"workload": workload, "seed": seed,
           "recorder": "on" if recorder else "off",
           "step_ms": sum(w.log.dur) / max(1, w.n_steps) * 1e3,
           "window_steps": w.n_steps,
           "device_idle_pct": readers.device_idle_pct(w)}
    if recorder:
        out["window"] = window_part(run)
        out["traced"] = traced_part(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", choices=("on", "off"), default="on")
    args = ap.parse_args(argv)
    from servebench.run import _cache_dirs
    if not torch.cuda.is_available():
        print("spantrace: needs a CUDA device", file=sys.stderr)
        return 2
    _cache_dirs()
    out = trace_cell(args.workload, args.seed, args.seconds,
                     args.recorder == "on")
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
