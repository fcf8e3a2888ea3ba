"""The trace reader: a bounded part of the window under ``torch.profiler``,
reduced in memory (nothing is written to disk).

* Device busy time is the union of the intervals of every device
  operation (kernels, copies, sets), so operations that overlap on two
  streams count once; the idle share is the rest of the traced span.
* Kernel time is summed by name, for the rooflines.
* Each idle gap is labelled by the innermost harness span the host was in
  at its middle (``step``, ``admit_batch``, ``order``, ``submit``,
  ``idle_wait``; "harness" outside them).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

__all__ = ["TraceSummary", "prepare_profiler", "summarize", "union_length",
           "idle_gaps", "label_gaps"]

LABELS = ("step", "admit_batch", "order", "submit", "idle_wait")
# idle gaps labelled and kept
TOP_GAPS = 200


@dataclass
class TraceSummary:
    window_s: float                 # the traced span, host clock
    busy_s: float                   # union of device intervals in it
    kernel_s: dict = field(default_factory=dict)   # name -> seconds
    gaps: list = field(default_factory=list)       # (label, seconds)


def prepare_profiler():
    """A profiler of the host and the device, started up (CUPTI) but not
    yet recording: ``start_trace()`` and ``stop_trace()`` then bound the
    traced span."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.prepare_trace()
    return prof


def union_length(intervals) -> tuple[float, list]:
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def idle_gaps(merged, lo: float, hi: float) -> list:
    """(start, end) of every stretch of [lo, hi] no merged interval
    covers."""
    gaps, t = [], lo
    for a, b in merged:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps, spans) -> list:
    """(label, length) of each gap: the innermost span (name, start, end)
    that holds the gap's middle, else "harness".  Spans nest at most a few
    deep (``order`` inside ``step``), so the few spans that start last
    before the middle are the only candidates."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid)
        best = None
        for name, s0, s1 in spans[max(0, j - 8):j]:
            if s1 >= mid and (best is None or s1 - s0 < best[2] - best[1]):
                best = (name, s0, s1)
        out.append((best[0] if best else "harness", b - a))
    return out


def _events(prof):
    """(on device, name, start us, end us) of every recorded event."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                s, d = float(e.start_us()), float(e.duration_us())
            out.append((e.device_type() == cuda, e.name(), s, s + d))
        return out
    for e in prof.events():
        out.append((e.device_type == cuda, e.name, e.time_range.start,
                    e.time_range.end))
    return out


def summarize(prof, host_t) -> TraceSummary:
    """Reduce a stopped profiler; ``host_t`` the host clock at its start
    and stop."""
    window_s = host_t[1] - host_t[0]
    events = _events(prof)
    if not events:
        return TraceSummary(window_s, 0.0)
    lo = min(e[2] for e in events)
    hi = lo + window_s * 1e6
    # the harness's own ranges appear on the device's timeline too
    ops = [(name, a, b) for on, name, a, b in events
           if on and name not in LABELS]
    dev = [(max(a, lo), min(b, hi)) for _, a, b in ops if b > lo and a < hi]
    busy, merged = union_length(dev)
    kernel_s: dict = {}
    for name, a, b in ops:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e6
    spans = [(name, a, b) for on, name, a, b in events
             if not on and name in LABELS]
    # every gap counts in the idle share; the longest are labelled
    gaps = sorted(idle_gaps(merged, lo, hi), key=lambda g: g[0] - g[1])
    gaps = [(name, s / 1e6) for name, s in label_gaps(gaps[:TOP_GAPS],
                                                      spans)]
    return TraceSummary(window_s=window_s, busy_s=busy / 1e6,
                        kernel_s=kernel_s, gaps=gaps)


def breakdown(ts: TraceSummary, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, each [name, seconds]."""
    ops = sorted(ts.kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(ts.gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def _short(name: str, width: int = 120) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width]
