"""Latency and throughput arithmetic of a measured window.

Each returns None where the window holds nothing to read.  Every time is
a host-clock reading (seconds, ``time.monotonic``).  A
request's record holds its due time (when it was to be sent: an open
loop times a request from then, so a stall that delays sending counts),
the stamps of its output tokens (each read when the engine step that
emitted it returned) and its finish stamp, if any.

Censoring: the window ends at ``end``.  A request that has not finished
by then counts at its age then, and one with no first token counts its
age as its time to first token.  Such a value is at least any time a
finish inside the window would have given, so leaving a request unserved
never lowers a mean or a percentile, and a stall raises them.  The open
gap of a started, unfinished request (``end`` minus its last token) counts
among the gaps between tokens for the same reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["RequestTimes", "ttlt_mean", "ttft_quantile", "gap_quantile",
           "window_tokens", "quantile"]


@dataclass
class RequestTimes:
    due: float
    token_stamps: list = field(default_factory=list)
    finish: float | None = None


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation (numpy's default)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("quantile of no values")
    return float(np.quantile(v, q))


def _arrived(recs, start: float, end: float):
    return [r for r in recs if start <= r.due < end]


def ttlt_mean(recs, start: float, end: float) -> float:
    """Mean time in the system of the requests due in [start, end):
    finish - due, or end - due for one unfinished at the end."""
    rows = _arrived(recs, start, end)
    if not rows:
        return None
    return float(np.mean([
        (r.finish if r.finish is not None and r.finish <= end else end)
        - r.due for r in rows]))


def ttft_quantile(recs, start: float, end: float, q: float) -> float:
    """q-quantile of the time to first token of the requests due in
    [start, end); one with no token by the end counts at its age then."""
    rows = _arrived(recs, start, end)
    if not rows:
        return None
    vals = []
    for r in rows:
        first = r.token_stamps[0] if r.token_stamps else None
        vals.append((first if first is not None and first <= end else end)
                    - r.due)
    return quantile(vals, q)


def gaps(recs, start: float, end: float) -> np.ndarray:
    """Every gap between consecutive output tokens of one request with
    both tokens in [start, end], and the open gap (end minus the last
    token) of every request that has a token in the window and has not
    finished by the end."""
    out = []
    for r in recs:
        ts = [t for t in r.token_stamps if start <= t <= end]
        if len(ts) >= 2:
            out.extend(np.diff(ts).tolist())
        # the gap from a token before the window into it counts too
        before = [t for t in r.token_stamps if t < start]
        if before and ts:
            out.append(ts[0] - before[-1])
        finished = r.finish is not None and r.finish <= end
        last = ts[-1] if ts else (before[-1] if before else None)
        if last is not None and not finished:
            out.append(end - last)
    return np.asarray(out, np.float64)


def gap_quantile(recs, start: float, end: float, q: float) -> float:
    g = gaps(recs, start, end)
    if g.size == 0:
        return None
    return quantile(g, q)


def window_tokens(recs, start: float, end: float) -> int:
    """Output tokens emitted in [start, end]."""
    return sum(sum(1 for t in r.token_stamps if start <= t <= end)
               for r in recs)
