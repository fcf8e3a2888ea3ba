"""Overload-hardened front door for the serving engine.

``ServingEngine.submit_batch`` accepts unboundedly: under sustained
overload the waiting queue grows without limit, every request's deadline
blows, and goodput collapses even though throughput looks fine.  The
``Gateway`` puts an event-driven admission layer in front of the engine
(the design skeleton is the classic bounded-queue gateway: per-tenant
bounded queues, explicit backpressure verdicts, stale-signal fallback to
static limits, clear overload behavior):

  * **Verdicts** — every ``offer()`` returns ACCEPT (submitted to the
    engine now), QUEUE (held in the tenant's bounded queue), or SHED
    (rejected under pressure; retried with exponential backoff until
    ``max_retries``, then terminal).
  * **Bounded queues** — one FIFO per tenant, ``max_queue_per_tenant``
    deep, drained round-robin across tenants so one tenant's burst
    cannot starve the rest; a global ``max_total_queue`` bound caps the
    aggregate backlog.
  * **Deadlines** — per-request TTFT/TTLT budgets (request-level fields
    override the config defaults).  A request that misses its budget is
    aborted through ``ServingEngine.abort``, which releases every device
    block, the slot, and any host swap payload (the block-leak
    regression in tests/test_faults.py aborts in every lifecycle state);
    a queued request whose deadline already passed is shed without
    wasting engine work.
  * **Uncertainty-aware shedding** — SageSched's core asset is the
    predicted cost *distribution*; under pressure the gateway drops the
    admissions with the worst goodput-per-predicted-cost, scoring each
    request by its ``CostDistribution`` upper quantile
    (``shed_quantile``): a wide right tail makes a request expensive in
    exactly the uncertainty-adjusted sense, so it is shed first.
  * **Degraded mode** — when the predictor / history store is
    unavailable (the scheduler's ``degraded`` flag, or a failed
    route-time prediction here), shedding falls back to FCFS tail-drop
    and admission to a conservative static in-flight limit: no request
    is ranked on information the gateway no longer trusts.

Every offered request ends with a terminal disposition — FINISHED,
SHED, or ABORTED, each with a reason — recorded in ``dispositions``;
``check_invariants()`` re-asserts KV block conservation and the
no-request-silently-lost ledger (the fault-injection harness calls it
after every injected fault).  See docs/serving_engine.md, "Overload &
failure semantics".
"""

from __future__ import annotations

import enum
import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .engine import EngineStallError, ServingEngine
from .request import RequestState, ServeRequest

__all__ = ["Gateway", "GatewayConfig", "Verdict"]


class Verdict(enum.Enum):
    ACCEPT = "accept"     # submitted to the engine in this call
    QUEUE = "queue"       # held in the tenant's bounded queue
    SHED = "shed"         # rejected under pressure (retried with backoff
                          # until max_retries, then terminal)


@dataclass
class GatewayConfig:
    max_queue_per_tenant: int = 64
    max_total_queue: int = 256
    # engine-resident bound (submitted, not yet terminal); None = 4x the
    # engine's slot count — enough backlog to keep the batch full without
    # letting the engine-side queue grow unboundedly
    max_inflight: int | None = None
    # static in-flight limit while degraded; None = the engine's n_slots
    degraded_max_inflight: int | None = None
    ttft_deadline_s: float | None = None   # default; request field overrides
    ttlt_deadline_s: float | None = None
    max_retries: int = 2
    retry_backoff_s: float = 0.05          # doubles per attempt
    shed_policy: str = "cost"              # "cost" | "tail"
    shed_quantile: float = 0.9             # CostDistribution upper quantile
    # exit hysteresis for the gateway-side degraded flag: this many
    # consecutive successful predictions before leaving the static
    # degraded_max_inflight limit (one lucky call must not flap it)
    degraded_exit_successes: int = 4


@dataclass
class _Entry:
    request: ServeRequest
    score: float = 0.0           # predicted-cost quantile (cost policy)
    length_dist: object = None   # forwarded to submit_batch (predict once)
    retries: int = 0


class Gateway:
    """Bounded-admission front door over one ``ServingEngine``."""

    def __init__(self, engine: ServingEngine,
                 config: GatewayConfig | None = None,
                 clock: Callable[[], float] | None = None):
        self.engine = engine
        self.config = config or GatewayConfig()
        if self.config.shed_policy not in ("cost", "tail"):
            raise ValueError(f"bad shed_policy {self.config.shed_policy!r}")
        # share the engine's clock by default so deadline math and
        # TTFT/TTLT stamps read the same time source (tests drive both
        # with one virtual clock)
        self.clock = clock or engine.clock
        self._queues: dict[str, deque[_Entry]] = {}
        self._rr: deque[str] = deque()          # round-robin tenant order
        self._retry: list[tuple[float, int, _Entry]] = []   # heap by due
        self._retry_seq = 0
        self._inflight: dict[str, ServeRequest] = {}
        self._offered: dict[str, ServeRequest] = {}
        self.dispositions: dict[str, tuple[str, str]] = {}
        self._degraded = False   # last gateway-side prediction failed
        self._ok_streak = 0      # consecutive successes (exit hysteresis)

    # ------------------------------------------------------------- state

    @property
    def degraded(self) -> bool:
        return self._degraded or getattr(self.engine.scheduler,
                                         "degraded", False)

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def drained(self) -> bool:
        return (not self._inflight and not self._retry and self.queued == 0
                and not self.engine.has_work)

    def _max_inflight(self) -> int:
        if self.degraded:
            return (self.config.degraded_max_inflight
                    or self.engine.n_slots)
        return self.config.max_inflight or 4 * self.engine.n_slots

    # ------------------------------------------------------------ scoring

    def _score(self, r: ServeRequest) -> tuple[float, object]:
        """Predicted-cost shed score: the ``shed_quantile`` of the
        request's cost distribution (uncertainty-aware — heavy right
        tails score high and are shed first).  A predictor failure flips
        the gateway into degraded mode and scores 0 (FCFS fallback);
        leaving degraded mode requires ``degraded_exit_successes``
        consecutive clean predictions (exit hysteresis — a single lucky
        call after an outage must not flap the static limits)."""
        sched = self.engine.scheduler
        try:
            dist = sched.predictor.predict(r.prompt, r.input_len)
            cost = sched.cost_model.distribution_batch(
                [r.input_len], [dist])[0]
            self._ok_streak += 1
            if self._degraded \
                    and self._ok_streak >= self.config.degraded_exit_successes:
                self._degraded = False
            return float(cost.quantile(self.config.shed_quantile)), dist
        except Exception:
            self._degraded = True
            self._ok_streak = 0
            return 0.0, None

    # -------------------------------------------------------------- offer

    def offer(self, request: ServeRequest) -> Verdict:
        """Admission decision for one request — the B = 1 case of
        ``offer_batch``."""
        return self.offer_batch([request])[0]

    def offer_batch(self, requests: list[ServeRequest]) -> list[Verdict]:
        """One admission decision per request; accepted requests are
        coalesced into a single ``submit_batch`` call (batch-first
        ingress all the way down)."""
        entries, verdicts = [], []
        for r in requests:
            if r.request_id in self._offered:
                raise KeyError(f"request {r.request_id!r} already offered")
            self._offered[r.request_id] = r
            score, dist = (self._score(r) if self.config.shed_policy
                           == "cost" else (0.0, None))
            entries.append(_Entry(r, score=score, length_dist=dist))
        accept: list[_Entry] = []
        for e in entries:
            verdicts.append(self._place(e, accept))
        self._submit(accept)
        return verdicts

    def _place(self, e: _Entry, accept: list[_Entry]) -> Verdict:
        """Route one entry to the engine, a queue, or the shed path."""
        tenant = e.request.tenant
        q = self._queues.get(tenant)
        if (self.inflight + len(accept) < self._max_inflight()
                and self.queued == 0):
            accept.append(e)
            return Verdict.ACCEPT
        if q is None:
            q = self._queues[tenant] = deque()
            self._rr.append(tenant)
        if (len(q) < self.config.max_queue_per_tenant
                and self.queued < self.config.max_total_queue):
            q.append(e)
            return Verdict.QUEUE
        # pressure: the tenant queue (or the global backlog) is full.
        # Cost policy sheds the worst goodput-per-predicted-cost request
        # among {queued} + {incoming}; degraded / tail policy sheds the
        # incoming request (FCFS tail-drop — no ranking on predictions)
        if self.config.shed_policy == "cost" and not self.degraded and q:
            worst = max(q, key=lambda x: x.score)
            if worst.score > e.score:
                q.remove(worst)
                q.append(e)
                self._shed(worst, "displaced_by_cheaper")
                return Verdict.QUEUE
        self._shed(e, "queue_full")
        return Verdict.SHED

    # --------------------------------------------------------------- shed

    def _shed(self, e: _Entry, reason: str, retryable: bool = True) -> None:
        """Reject an entry: back into the retry heap while attempts
        remain (exponential backoff), terminal SHED after that."""
        if retryable and e.retries < self.config.max_retries:
            due = self.clock() + self.config.retry_backoff_s * (2 ** e.retries)
            e.retries += 1
            self._retry_seq += 1
            heapq.heappush(self._retry, (due, self._retry_seq, e))
            return
        r = e.request
        r.state = RequestState.SHED
        r.finish_reason = reason
        self.dispositions[r.request_id] = ("SHED", reason)
        self.engine.metrics.shed += 1

    # --------------------------------------------------------------- pump

    def _submit(self, entries: list[_Entry]) -> None:
        if not entries:
            return
        reqs = [e.request for e in entries]
        self.engine.submit_batch(
            reqs, length_dists=[e.length_dist for e in entries])
        for r in reqs:
            self._inflight[r.request_id] = r

    def _reap(self) -> None:
        """Record terminal dispositions for engine-side completions."""
        for rid in [rid for rid, r in self._inflight.items() if r.done]:
            r = self._inflight.pop(rid)
            kind = ("FINISHED" if r.state == RequestState.FINISHED
                    else "ABORTED")
            self.dispositions[rid] = (kind, r.finish_reason or kind.lower())

    def _deadline(self, r: ServeRequest, which: str) -> float | None:
        own = getattr(r, f"{which}_deadline_s")
        return own if own is not None \
            else getattr(self.config, f"{which}_deadline_s")

    def _enforce_deadlines(self, now: float) -> None:
        # engine-resident requests: abort releases blocks + swap payloads
        for rid, r in list(self._inflight.items()):
            if r.done:
                continue
            ttlt = self._deadline(r, "ttlt")
            if ttlt is not None and now - r.arrival > ttlt:
                self.engine.abort(rid, reason="ttlt_deadline")
                continue
            ttft = self._deadline(r, "ttft")
            if ttft is not None and np.isnan(r.ttft) \
                    and now - r.arrival > ttft:
                self.engine.abort(rid, reason="ttft_deadline")
        # queued requests past any deadline are shed without engine work;
        # arrival is unstamped (0.0) until submit, so measure from offer
        # only when the caller stamped it
        for tenant, q in self._queues.items():
            for e in [e for e in q
                      if self._queued_expired(e.request, now)]:
                q.remove(e)
                self._shed(e, "deadline", retryable=False)

    def _queued_expired(self, r: ServeRequest, now: float) -> bool:
        if r.arrival == 0.0:
            return False
        for which in ("ttft", "ttlt"):
            d = self._deadline(r, which)
            if d is not None and now - r.arrival > d:
                return True
        return False

    def tick(self) -> None:
        """One gateway event-loop turn: reap completions, enforce
        deadlines, replay due retries, and pump the queues into the
        engine (one coalesced ``submit_batch``)."""
        now = self.clock()
        self._reap()
        self._enforce_deadlines(now)
        self._reap()
        # due retries re-enter admission (counted as retry attempts)
        while self._retry and self._retry[0][0] <= now:
            _, _, e = heapq.heappop(self._retry)
            self.engine.metrics.retries += 1
            accept: list[_Entry] = []
            self._place(e, accept)
            self._submit(accept)
        # round-robin pump: fill the engine up to the in-flight bound
        accept = []
        bound = self._max_inflight()
        while self.inflight + len(accept) < bound and self.queued > 0:
            for _ in range(len(self._rr)):
                tenant = self._rr[0]
                self._rr.rotate(-1)
                q = self._queues.get(tenant)
                if q:
                    accept.append(q.popleft())
                    break
            else:
                break
        self._submit(accept)

    def step(self) -> int:
        """tick + one engine iteration."""
        self.tick()
        return self.engine.step() if self.engine.has_work else 0

    def run_until_drained(self, max_steps: int = 100_000,
                          step_dt: float = 0.0) -> None:
        """Drive tick+step until every offered request is terminal.
        ``step_dt`` advances a virtual clock per step (deterministic
        deadline storms); with an idle engine and pending retries the
        virtual clock jumps to the next retry's due time."""
        advance = getattr(self.clock, "advance", None)
        for _ in range(max_steps):
            if self.drained:
                return
            self.step()
            if advance is not None:
                if step_dt:
                    advance(step_dt)
                elif not self.engine.has_work and self._retry:
                    advance(max(0.0, self._retry[0][0] - self.clock()))
        raise EngineStallError(
            f"gateway: drain budget ({max_steps}) exhausted — "
            f"queued={self.queued} retrying={len(self._retry)} "
            f"inflight={self.inflight}; engine={self.engine.stall_report()}")

    # ------------------------------------------------------------- summary

    def summary(self) -> dict:
        """Operator-facing gateway snapshot: live admission state, the
        disposition ledger rolled up by (kind, reason), and the adaptive-
        robustness surfaces — per-tenant calibration statistics from the
        scheduler's ``CalibrationMonitor`` and the hedge-weight snapshot
        when the engine schedules with ``HedgedPolicy``."""
        kinds: dict[str, int] = {}
        reasons: dict[str, int] = {}
        for kind, reason in self.dispositions.values():
            kinds[kind] = kinds.get(kind, 0) + 1
            key = f"{kind.lower()}:{reason}"
            reasons[key] = reasons.get(key, 0) + 1
        out = {
            "queued": self.queued,
            "inflight": self.inflight,
            "retrying": len(self._retry),
            "degraded": self.degraded,
            "dispositions": kinds,
            "disposition_reasons": reasons,
        }
        sched = self.engine.scheduler
        if hasattr(sched, "calibration_summary"):
            out["calibration"] = sched.calibration_summary()
        pol = getattr(sched, "policy", None)
        if hasattr(pol, "snapshot"):
            out["hedge"] = pol.snapshot()
        return out

    # ---------------------------------------------------------- invariants

    def check_invariants(self) -> None:
        """Fault-harness postconditions: KV block/slot conservation and
        the no-request-silently-lost ledger (every offered id is either
        still live — queued, retrying, in flight — or has a terminal
        disposition with a reason)."""
        self.engine.kv.assert_conserved()
        live = set(self._inflight) | {
            e.request.request_id
            for q in self._queues.values() for e in q}
        live |= {e.request.request_id for _, _, e in self._retry}
        for rid in self._offered:
            if rid in self.dispositions:
                kind, reason = self.dispositions[rid]
                if kind not in ("FINISHED", "SHED", "ABORTED") or not reason:
                    raise RuntimeError(
                        f"{rid}: bad disposition {kind!r}/{reason!r}")
            elif rid not in live:
                raise RuntimeError(f"request {rid} silently lost")

    def assert_all_terminal(self) -> None:
        """Post-drain: every offered id has a terminal disposition."""
        self.check_invariants()
        missing = [rid for rid in self._offered
                   if rid not in self.dispositions]
        if missing:
            raise RuntimeError(
                f"{len(missing)} requests lack terminal dispositions: "
                f"{missing[:5]}")
