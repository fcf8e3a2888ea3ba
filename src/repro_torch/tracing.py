"""Spans of the port's host work, on the clock of ``torch.profiler``'s trace.

One recorder per process, as ``torch.profiler`` is one.  A span is a
record (name, start ns, end ns, index of its parent span, request id or
None), its name ``<layer>.<part>``; a span given no request id takes its
parent's, so every span of a request carries its id.  Stamps are
``time.time_ns()``: kineto's events carry Unix-epoch nanoseconds too
(``start_ns()``), so the spans and the device's intervals lie on one
timeline with no offset to estimate.  Counts stay in
``serving.metrics.EngineMetrics``: the recorder holds only spans, in
memory until ``drain()``; nothing is written, logged or exported.

The recorder is off by default.  ``span`` then costs one attribute test
and returns a shared no-op context: no allocation, no clock read.  It
records between ``enable()`` and ``disable()`` only; whoever enables it
drains it.  Spans nest on one thread.
"""

from __future__ import annotations

import time
from typing import NamedTuple

__all__ = ["Span", "Recorder", "RECORDER", "span", "enable", "disable",
           "drain", "self_ns"]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index of the enclosing span in the list, or -1
    rid: str | None


class Recorder:
    """The process's spans: the closed and open records in start order
    ([name, start, end, parent, rid]) and the stack of open ones."""

    __slots__ = ("on", "records", "stack")

    def __init__(self):
        self.on = False
        self.records: list = []
        self.stack: list = []


RECORDER = Recorder()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """One span being recorded."""

    __slots__ = ("name", "rid", "i")

    def __init__(self, name: str, rid):
        self.name, self.rid = name, rid

    def __enter__(self):
        rec = RECORDER
        parent = rec.stack[-1] if rec.stack else -1
        rid = self.rid
        if rid is None and parent >= 0:
            rid = rec.records[parent][4]
        self.i = len(rec.records)
        rec.stack.append(self.i)
        rec.records.append([self.name, time.time_ns(), 0, parent, rid])
        return self

    def __exit__(self, *exc):
        rec = RECORDER
        rec.records[self.i][2] = time.time_ns()
        rec.stack.pop()
        return False


def span(name: str, rid: str | None = None):
    """A context that records the span ``name`` (of request ``rid``) while
    the recorder is on, and does nothing otherwise."""
    if not RECORDER.on:
        return _NULL
    return _Open(name, rid)


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def drain() -> list[Span]:
    """The spans recorded since the last drain, in start order (a parent
    before its children), and an empty recorder.  Call it with no span
    open."""
    rec = RECORDER
    if rec.stack:
        raise RuntimeError(f"tracing.drain: {len(rec.stack)} span(s) still "
                           "open")
    out = [Span(*r) for r in rec.records]
    rec.records = []
    return out


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's self time: its duration less the part of it its child
    spans cover (the children of one span follow one another on one
    thread, so their cover is the sum of their lengths)."""
    own = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    return own
