"""The program's own spans (``repro_torch.tracing``) read into numbers of
its host work, and idle gaps labelled by the innermost span.

Each reader takes the spans of one stretch of a run, as one drain of the
recorder returns them (a parent before its children), and returns a
number, or None where the spans hold no step.  ``servebench/spantrace.py``
reads them over a run's window; the benchmark's result line reads none of
them (``run.py`` never switches the recorder on).

Idle gaps: each is labelled by the innermost span, the harness's
``record_function`` ranges and the program's spans alike, that holds its
middle.  ``label_gaps`` finds the shortest span holding a point at any
depth of nesting; on the harness's own spans it gives ``trace.label_gaps``'s
labels.
"""

from __future__ import annotations

import heapq

__all__ = ["step_host_ms", "swap_ms_per_step", "predict_ms_per_req",
           "self_ms_per_step", "events_us", "label_gaps", "idle_by_span"]

STEP = "engine.step"
# spans in which the card works and the host waits on it (the swaps'
# copies are synchronous)
DEVICE_WAITS = ("runner.wait", "kv.swap_out", "kv.swap_in")
SWAPS = ("kv.swap_out", "kv.swap_in")
PREDICT = ("sched.predict", "sched.observe")


def _ns_in_steps(spans, names) -> tuple[dict, list]:
    """Per ``engine.step`` root: the ns of its descendants named in
    ``names`` (they never nest in one another); and the step roots."""
    top = []
    for i, s in enumerate(spans):
        top.append(i if s.parent < 0 else top[s.parent])
    steps = [i for i, s in enumerate(spans)
             if s.parent < 0 and s.name == STEP]
    acc = dict.fromkeys(steps, 0)
    for i, s in enumerate(spans):
        if s.name in names and top[i] in acc and i != top[i]:
            acc[top[i]] += s.end_ns - s.start_ns
    return acc, steps


def step_host_ms(spans):
    """Host ms a step spends in ``engine.step`` outside its
    ``runner.wait``, ``kv.swap_out`` and ``kv.swap_in`` spans: the time
    the card waits on the host."""
    waits, steps = _ns_in_steps(spans, DEVICE_WAITS)
    if not steps:
        return None
    host = sum(spans[i].end_ns - spans[i].start_ns - waits[i]
               for i in steps)
    return host / len(steps) / 1e6


def swap_ms_per_step(spans):
    """Host ms a step spends in ``kv.swap_out`` and ``kv.swap_in`` (each
    gathers or restores a request's pages, its copies included)."""
    swaps, steps = _ns_in_steps(spans, SWAPS)
    if not steps:
        return None
    return sum(swaps.values()) / len(steps) / 1e6


def predict_ms_per_req(spans, requests: int):
    """Ms in ``sched.predict`` (the admission's embedding and retrieval)
    and ``sched.observe`` (the completion's history update) over
    ``requests``, the requests attempted in the same stretch."""
    if not requests:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in PREDICT)
    return ns / requests / 1e6


def self_ms_per_step(spans) -> dict:
    """Each span name's self time (``tracing.self_ns``), ms a step,
    largest first."""
    from repro_torch.tracing import self_ns
    n = sum(1 for s in spans if s.parent < 0 and s.name == STEP)
    acc: dict = {}
    for s, own in zip(spans, self_ns(spans)):
        acc[s.name] = acc.get(s.name, 0.0) + own / 1e6 / max(1, n)
    return dict(sorted(acc.items(), key=lambda kv: -kv[1]))


def events_us(spans) -> list:
    """(name, start us, end us) of program spans, on the kineto events'
    microseconds (both count from the Unix epoch)."""
    return [(s.name, s.start_ns / 1e3, s.end_ns / 1e3) for s in spans]


def label_gaps(gaps, spans) -> list:
    """(label, length) of each gap (start, end): the innermost span (name,
    start, end) that holds the gap's middle, the shortest where several
    do (ties to the one starting first), else "harness".  One sweep over
    the middles in order with a heap of the spans begun, shortest first:
    a span that ended before a middle holds no later one, so it leaves
    the heap for good.  Right at any depth of nesting."""
    order = sorted(spans, key=lambda s: s[1])
    mids = sorted(range(len(gaps)), key=lambda k: gaps[k][0] + gaps[k][1])
    out = [None] * len(gaps)
    heap: list = []
    j = 0
    for k in mids:
        a, b = gaps[k]
        mid = (a + b) / 2
        while j < len(order) and order[j][1] <= mid:
            name, s0, s1 = order[j]
            heapq.heappush(heap, (s1 - s0, j, s1, name))
            j += 1
        while heap and heap[0][2] < mid:
            heapq.heappop(heap)
        out[k] = (heap[0][3] if heap else "harness", b - a)
    return out


def idle_by_span(gaps, spans) -> dict:
    """Idle seconds by innermost span over every gap (us in, s out),
    largest first."""
    acc: dict = {}
    for name, us in label_gaps(gaps, spans):
        acc[name] = acc.get(name, 0.0) + us / 1e6
    return dict(sorted(acc.items(), key=lambda kv: -kv[1]))
