"""Fault injection for the serving stack, plus post-fault invariants.

The overload/robustness story (gateway shedding, degraded prediction-free
scheduling, swap-fault recompute, node kill/slow in the cluster
simulator) is only trustworthy if every failure mode can be *provoked on
demand* and the system's invariants checked afterwards.  This module is
that provocation kit:

  * ``VirtualClock`` — an injectable monotonic clock (``ServingEngine.
    clock`` / ``Gateway``) so deadline storms and retry backoff are
    deterministic and instant in tests;
  * ``FlakyPredictor`` — wraps any ``repro_torch.core.Predictor`` and, over a
    chosen call window, raises (``outage``), returns wildly-wrong point
    masses (``corrupt``), or replays its first answer forever
    (``stale``) — the predictor-failure modes that must push the
    scheduler into degraded prediction-free mode (flat prior, FCFS-ish)
    rather than crash admission;
  * ``inject_kv_fault`` — a context manager that makes one
    ``KVCacheManager`` instance's ``swap_in`` raise ``KVFaultError`` or
    its ``grow`` report exhaustion over a chosen call window, exercising
    the engine's recompute-on-lost-payload and pressure-relief paths;
  * ``assert_engine_quiesced`` — the post-fault invariant bundle: block
    accounting conserves exactly and every submitted request reached a
    terminal state with a recorded reason.

Node-level faults (kill / slow-down) live in the simulator itself:
``repro_torch.simulator.NodeKill`` / ``NodeSlow`` events handed to
``simulate_cluster(..., faults=[...])``.  Overload injection lives in
the workload generator (``generate_workload(..., burst_factor=...)``).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from ..core.predictor import LengthDistribution, Predictor

__all__ = ["VirtualClock", "PredictorUnavailable", "KVFaultError",
           "FlakyPredictor", "scale_distribution", "inject_kv_fault",
           "assert_engine_quiesced"]


def scale_distribution(dist: LengthDistribution, scale: float,
                       bias: float = 0.0) -> LengthDistribution:
    """Length-scale a predicted distribution: lengths become
    ``round(length * scale + bias)`` (floored at 1); collided support
    points merge their mass.  Used by the ``drift`` fault mode and by
    the drift bench's oracle-truth construction, so both sides of the
    regret comparison transform predictions identically."""
    lens = np.maximum(
        np.round(dist.lengths * float(scale) + float(bias)), 1.0
    ).astype(np.int64)
    uniq, inv = np.unique(lens, return_inverse=True)
    probs = np.zeros(uniq.shape[0])
    np.add.at(probs, inv, dist.probs)
    return LengthDistribution(uniq, probs)


class VirtualClock:
    """A hand-advanced monotonic clock, duck-compatible with
    ``time.monotonic`` (callable returning seconds).  Inject as
    ``ServingEngine(clock=VirtualClock())`` to make TTFT/TTLT deadlines
    and gateway retry backoff deterministic."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("a monotonic clock cannot go backwards")
        self.now += float(dt)
        return self.now


class PredictorUnavailable(RuntimeError):
    """The injected predictor-outage error (timeout / dead sidecar)."""


class KVFaultError(RuntimeError):
    """The injected KV-plane error (lost swap payload, failed DMA)."""


class FlakyPredictor(Predictor):
    """Wrap ``inner`` and misbehave over calls [fail_after, fail_after +
    n_failures).  Counting is per *request* (one batched predict over a
    burst of k prompts counts k), so fault windows line up with request
    indices regardless of how callers batch.

    modes: ``outage`` raises ``PredictorUnavailable``; ``corrupt``
    returns a point mass at ``corrupt_scale *`` the true predicted mean
    (confidently, arbitrarily wrong); ``stale`` replays the first answer
    it ever produced (a stuck / delayed predictor); ``drift`` keeps
    answering confidently but with a length scale that ramps from 1x at
    the window's start to ``drift_scale`` at its end (plus an additive
    ``drift_bias`` ramping the same way) — the predictor nobody notices
    is broken, because it never throws.  Unlike the other modes, drift
    is the failure the scheduler can only detect *statistically*
    (calibration monitoring) and survive *adaptively* (posteriors,
    hedging) — see repro_torch.core.robust.
    """

    MODES = ("outage", "corrupt", "stale", "drift")

    def __init__(self, inner: Predictor, mode: str = "outage",
                 fail_after: int = 0, n_failures: int | None = None,
                 corrupt_scale: float = 16.0, drift_scale: float = 2.0,
                 drift_bias: float = 0.0):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.inner = inner
        self.mode = mode
        self.fail_after = int(fail_after)
        self.n_failures = (float("inf") if n_failures is None
                           else int(n_failures))
        self.corrupt_scale = float(corrupt_scale)
        self.drift_scale = float(drift_scale)
        self.drift_bias = float(drift_bias)
        self.calls = 0
        self.faults = 0
        self._stale: LengthDistribution | None = None

    def _in_window(self) -> bool:
        i = self.calls
        self.calls += 1
        hit = self.fail_after <= i < self.fail_after + self.n_failures
        if hit:
            self.faults += 1
        return hit

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        if not self._in_window():
            dist = self.inner.predict(prompt, int(input_len))
            if self._stale is None:
                self._stale = dist
            return dist
        if self.mode == "outage":
            raise PredictorUnavailable(
                f"injected predictor outage (call {self.calls - 1})")
        if self.mode == "stale" and self._stale is not None:
            return self._stale
        dist = self.inner.predict(prompt, int(input_len))
        if self.mode == "corrupt":
            wrong = max(1, int(dist.mean * self.corrupt_scale))
            return LengthDistribution(np.array([wrong], np.int64),
                                      np.array([1.0]))
        if self.mode == "drift":
            i = self.calls - 1  # _in_window already advanced the counter
            frac = 1.0 if not np.isfinite(self.n_failures) else \
                min(1.0, (i - self.fail_after + 1) / self.n_failures)
            s = 1.0 + (self.drift_scale - 1.0) * frac
            return scale_distribution(dist, s, self.drift_bias * frac)
        return dist  # stale mode before any healthy call was seen

    def predict_batch(self, prompts, input_lens):
        # loop the scalar path so the per-request fault window holds
        return [self.predict(p, int(il))
                for p, il in zip(prompts, input_lens)]

    def observe(self, prompt: str, input_len: int, output_len: int) -> None:
        self.inner.observe(prompt, input_len, output_len)


@contextmanager
def inject_kv_fault(kv, method: str = "swap_in", at_call: int = 0,
                    n_calls: int | None = None):
    """Make ONE KVCacheManager instance's ``method`` fail over calls
    [at_call, at_call + n_calls): ``grow`` reports exhaustion (returns
    False — the engine's normal memory-pressure signal), any other
    method raises ``KVFaultError`` (a lost swap payload / failed DMA —
    ``ServingEngine._admit`` recovers by dropping the payload and
    recomputing prefill).  Yields a stats dict (``calls``/``faults``);
    the instance is restored on exit even if the body raises."""
    orig = getattr(kv, method)
    lo = int(at_call)
    hi = lo + (float("inf") if n_calls is None else int(n_calls))
    stats = {"calls": 0, "faults": 0}

    def wrapper(*args, **kwargs):
        i = stats["calls"]
        stats["calls"] += 1
        if lo <= i < hi:
            stats["faults"] += 1
            if method == "grow":
                return False
            raise KVFaultError(f"injected {method} fault (call {i})")
        return orig(*args, **kwargs)

    setattr(kv, method, wrapper)
    try:
        yield stats
    finally:
        if kv.__dict__.get(method) is wrapper:
            del kv.__dict__[method]  # re-expose the bound class method


def assert_engine_quiesced(engine) -> None:
    """Post-fault invariant bundle for a drained ``ServingEngine``:

      * KV block accounting conserves exactly
        (``KVCacheManager.assert_conserved``), and the prefix index
        matches a from-scratch rebuild (``check_prefix_index``);
      * no shared-block refcount outlives its readers: with every
        request terminal, the refcount map must be empty — sharing has
        dropped back to private-only (nothing), only refcount-0 cached
        prefix blocks may remain;
      * no request is still live;
      * every non-FINISHED terminal request carries a ``finish_reason``
        (nothing vanished without an attributable cause).
    """
    engine.kv.assert_conserved()
    engine.kv.check_prefix_index()
    from ..serving.request import RequestState
    stuck = {rid: r.state.value
             for rid, r in engine._requests.items() if not r.done}
    if stuck:
        raise AssertionError(f"engine not quiesced; live requests: {stuck}")
    lingering = engine.kv.live_refcounts()
    if lingering:
        shared = {b: c for b, c in lingering.items() if c > 1}
        raise AssertionError(
            "blocks still referenced after every request reached a "
            f"terminal state: {lingering} (shared: {shared})")
    unexplained = [
        rid for rid, r in engine._requests.items()
        if r.state in (RequestState.ABORTED, RequestState.SHED)
        and not r.finish_reason]
    if unexplained:
        raise AssertionError(
            f"terminal requests without a finish_reason: {unexplained}")
