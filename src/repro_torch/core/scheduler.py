"""SageSched scheduler facade (paper Fig. 3 workflow).

Wires the three techniques together for use by both the real serving
engine (repro_torch.serving.engine) and the discrete-event simulator
(repro.simulator, not yet ported):

    arrival  -> predictor.predict()  -> length distribution
             -> cost_model.distribution() -> cost distribution
             -> policy.priority()    -> queue index

    progress -> attained cost grows; *refreshing* policies recompute the
                priority only when the request crosses a token-bucket
                boundary (default bucket_size=200 tokens, Fig. 13b) —
                balancing rescheduling timeliness against thrashing.

    completion -> predictor.observe() feeds the history window.

The scheduler is backend-agnostic: callers ask for ``order()`` over any
subset of live request ids and apply their own admission constraints
(KV capacity, max batch) — exactly how vLLM separates policy from the
block manager.

Array-native hot path
---------------------
At cluster scale (Fig. 12) the decision loop dominates: thousands of
Gittins refreshes per second.  The scheduler therefore keeps all live
requests in a ``BatchState`` — a structure-of-arrays mirror of the
per-request objects: bucketized (n, k) cost/length distributions plus
parallel ``generated`` / ``attained`` / ``arrival`` / ``next_refresh`` /
``priority`` vectors.  ``on_progress`` only *marks rows dirty*;
``refresh()`` recomputes every dirty priority in one fused pass through a
pluggable backend (vectorized numpy, or the CUDA Gittins kernel), and
``order()`` is a single ``np.lexsort`` over the priority/arrival arrays.
``priority_backend="object"`` preserves the original object-at-a-time
path as the oracle; the numpy backend is engineered to be bit-identical
to it (see docs/scheduler_internals.md).

Batch-first ingress
-------------------
Admission is batched the same way: ``admit_batch`` registers a
whole burst of arrivals through one ``Predictor.predict_batch`` call,
one cost-model sweep, one ``BatchState.add_batch`` append and one
vectorized initial-priority evaluation; scalar ``admit`` is its B = 1
case.  The two are bit-identical — see the "Batched ingress" section of
docs/scheduler_internals.md.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .backends import (BatchView, NumpyPriorityBackend,
                       make_priority_backend)
from .cost_model import (CostDistribution, CostModel, ResourceBoundCost,
                         bucketize_support, eviction_scores)
from .policies import Policy, SageSchedPolicy, make_policy
from .predictor import LengthDistribution, Predictor, SemanticHistoryPredictor
from .robust import CalibrationMonitor, truncate_rows

__all__ = ["ScheduledRequest", "BatchState", "Scheduler"]

# Admission-time priorities are always evaluated in float64 numpy (the
# backend that is bit-identical to the scalar oracle), no matter which
# refresh backend the scheduler was configured with — see
# Scheduler._admission_priorities.
_ADMIT_BACKEND = NumpyPriorityBackend()


@dataclass
class ScheduledRequest:
    """Scheduler-side state for one live request.

    Under a batched backend the authoritative copies of ``generated`` /
    ``attained_cost`` / ``next_refresh`` / ``priority`` live in
    ``BatchState``; ``Scheduler.get`` syncs them back on access.
    """

    request_id: str
    prompt: str
    input_len: int
    arrival: float
    length_dist: LengthDistribution
    cost_dist: CostDistribution
    generated: int = 0            # output tokens produced so far
    attained_cost: float = 0.0    # cost consumed so far (cost-model units)
    next_refresh: float = float("inf")  # generated count of next refresh
    priority: float = 0.0         # cached policy priority (smaller = sooner)
    node_id: int = -1             # serving node (cluster mode; -1 = unassigned)
    tenant: str = "default"       # calibration-monitoring key
    # generated count triggering the next mid-flight posterior update
    # (inf = posterior updates disabled)
    posterior_cut: float = float("inf")
    # the admission-time prediction, kept pristine for completion-time
    # scoring (hedge weights / calibration must grade the predictor, not
    # the trivially-covering posterior); None when it was a degraded-mode
    # prior — there is nothing to grade
    pred_dist: LengthDistribution | None = field(default=None, repr=False)
    noise_rng: np.random.Generator | None = field(default=None, repr=False)


class BatchState:
    """Structure-of-arrays store for all live requests.

    Rows are dense in [0, n); removal swaps the last row into the hole.
    Columns (k) hold bucketized distributions: support is non-decreasing,
    padded entries repeat the last real support value and carry prob 0 —
    a padding every batched consumer treats as exactly inert.  Row
    capacity doubles amortized; column width auto-grows (power-of-two,
    capped at ``max_k``) so compression only kicks in past ``max_k``.
    """

    def __init__(self, k: int = 8, cap: int = 64, max_k: int = 256):
        self.k = int(k)
        self.cap = int(cap)
        self.max_k = int(max_k)
        self.n = 0
        self.cost_sup = np.zeros((self.cap, self.k))
        self.cost_probs = np.zeros((self.cap, self.k))
        self.len_sup = np.zeros((self.cap, self.k))
        self.len_probs = np.zeros((self.cap, self.k))
        self.generated = np.zeros(self.cap, np.int64)
        self.attained = np.zeros(self.cap)
        self.arrival = np.zeros(self.cap)
        self.input_len = np.zeros(self.cap, np.int64)
        self.next_refresh = np.full(self.cap, np.inf)
        self.priority = np.zeros(self.cap)
        self.base_priority = np.zeros(self.cap)
        self.node_id = np.full(self.cap, -1, np.int64)
        self.cost_mean = np.zeros(self.cap)
        self.posterior_cut = np.full(self.cap, np.inf)
        self.dirty = np.zeros(self.cap, bool)
        self.ids: list[str] = []
        self.index: dict[str, int] = {}

    # ------------------------------------------------------------- growth

    def _grow_rows(self) -> None:
        new_cap = self.cap * 2
        for name in ("cost_sup", "cost_probs", "len_sup", "len_probs"):
            old = getattr(self, name)
            arr = np.zeros((new_cap, self.k), old.dtype)
            arr[:self.cap] = old
            setattr(self, name, arr)
        for name, fill in (("generated", 0), ("attained", 0.0),
                           ("arrival", 0.0), ("input_len", 0),
                           ("next_refresh", np.inf), ("priority", 0.0),
                           ("base_priority", 0.0), ("node_id", -1),
                           ("cost_mean", 0.0), ("posterior_cut", np.inf),
                           ("dirty", False)):
            old = getattr(self, name)
            arr = np.full(new_cap, fill, old.dtype)
            arr[:self.cap] = old
            setattr(self, name, arr)
        self.cap = new_cap

    def _grow_cols(self, k_needed: int) -> None:
        k_new = self.k
        while k_new < k_needed:
            k_new *= 2
        k_new = min(k_new, self.max_k)
        if k_new <= self.k:
            return
        pad = k_new - self.k
        for name in ("cost_sup", "len_sup"):
            # edge-repeat keeps the pad-with-last-support invariant
            setattr(self, name,
                    np.pad(getattr(self, name), ((0, 0), (0, pad)),
                           mode="edge"))
        for name in ("cost_probs", "len_probs"):
            setattr(self, name,
                    np.pad(getattr(self, name), ((0, 0), (0, pad))))
        self.k = k_new

    # ------------------------------------------------------------ rows

    def add(self, rid: str, cost_dist: CostDistribution,
            length_dist: LengthDistribution, *, arrival: float,
            input_len: int, next_refresh: float, priority: float,
            base_priority: float, node_id: int = -1) -> int:
        """Append one row — semantically the B = 1 case of ``add_batch``,
        kept as direct scalar writes (no index arrays) because single
        admissions remain a hot path for non-bursty callers."""
        k_needed = max(cost_dist.support.shape[0],
                       length_dist.lengths.shape[0])
        if k_needed > self.k:
            self._grow_cols(k_needed)
        if self.n == self.cap:
            self._grow_rows()
        i = self.n
        self._write_row(self.cost_sup, self.cost_probs, i,
                        cost_dist.support, cost_dist.probs)
        self._write_row(self.len_sup, self.len_probs, i,
                        length_dist.lengths, length_dist.probs)
        self.generated[i] = 0
        self.attained[i] = 0.0
        self.arrival[i] = arrival
        self.input_len[i] = input_len
        self.next_refresh[i] = next_refresh
        self.priority[i] = priority
        self.base_priority[i] = base_priority
        self.node_id[i] = node_id
        self.cost_mean[i] = cost_dist.mean
        self.posterior_cut[i] = np.inf
        self.dirty[i] = False
        self.ids.append(rid)
        self.index[rid] = i
        self.n += 1
        return i

    def _write_row(self, sup_arr: np.ndarray, prob_arr: np.ndarray, i: int,
                   support: np.ndarray, probs: np.ndarray) -> None:
        """Write one bucketized distribution row in place (no concatenate
        allocations on the admit hot path)."""
        k0 = support.shape[0]
        if k0 <= self.k:
            sup_arr[i, :k0] = support
            sup_arr[i, k0:] = support[-1]   # repeat-last pad
            prob_arr[i, :k0] = probs
            prob_arr[i, k0:] = 0.0
        else:  # > max_k: lossy equal-mass compression
            s, p = bucketize_support(np.asarray(support, np.float64),
                                     probs, self.k)
            sup_arr[i] = s
            prob_arr[i] = p

    def add_batch(self, rids: list[str], cost_dists, length_dists, *,
                  arrivals, input_lens, next_refreshes, priorities,
                  base_priorities, node_ids) -> np.ndarray:
        """Append B rows in one pass: ONE column grow (to the widest
        distribution in the batch), ONE amortized row grow, ragged
        per-row distribution writes, then vectorized scalar-column
        writes.  State afterwards is identical to B sequential ``add``
        calls (power-of-two growth commutes with batching).  Returns the
        new row indices."""
        b = len(rids)
        if b == 0:
            return np.zeros(0, np.int64)
        k_needed = max(max(cd.support.shape[0] for cd in cost_dists),
                       max(ld.lengths.shape[0] for ld in length_dists))
        if k_needed > self.k:
            self._grow_cols(k_needed)
        while self.cap < self.n + b:
            self._grow_rows()
        i0 = self.n
        idx = np.arange(i0, i0 + b)
        for j in range(b):
            i = i0 + j
            self._write_row(self.cost_sup, self.cost_probs, i,
                            cost_dists[j].support, cost_dists[j].probs)
            self._write_row(self.len_sup, self.len_probs, i,
                            length_dists[j].lengths, length_dists[j].probs)
            self.cost_mean[i] = cost_dists[j].mean
            self.index[rids[j]] = i
        self.ids.extend(rids)
        self.generated[idx] = 0
        self.attained[idx] = 0.0
        self.arrival[idx] = arrivals
        self.input_len[idx] = input_lens
        self.next_refresh[idx] = next_refreshes
        self.priority[idx] = priorities
        self.base_priority[idx] = base_priorities
        self.node_id[idx] = node_ids
        self.posterior_cut[idx] = np.inf
        self.dirty[idx] = False
        self.n += b
        return idx

    def remove(self, rid: str) -> None:
        i = self.index.pop(rid)
        last = self.n - 1
        if i != last:
            for name in ("cost_sup", "cost_probs", "len_sup", "len_probs",
                         "generated", "attained", "arrival", "input_len",
                         "next_refresh", "priority", "base_priority",
                         "node_id", "cost_mean", "posterior_cut", "dirty"):
                arr = getattr(self, name)
                arr[i] = arr[last]
            moved = self.ids[last]
            self.ids[i] = moved
            self.index[moved] = i
        self.ids.pop()
        self.dirty[last] = False
        self.n -= 1

    def view(self, idx: np.ndarray) -> BatchView:
        if idx.shape[0] == self.n:
            idx = slice(0, self.n)  # all rows dirty: zero-copy slices
        return BatchView(
            cost_sup=self.cost_sup[idx], cost_probs=self.cost_probs[idx],
            len_sup=self.len_sup[idx], len_probs=self.len_probs[idx],
            generated=self.generated[idx], attained=self.attained[idx],
            arrival=self.arrival[idx], input_len=self.input_len[idx])


class Scheduler:
    """Predictor + cost model + policy, with bucketized priority refresh.

    priority_backend: "numpy" (default, vectorized float64 hot path),
        "cuda" (hand-written CUDA kernel; its plain torch version on CPU), "object" (the
        original per-request scalar path, kept as the oracle), or a
        ``PriorityBackend`` instance.
    """

    def __init__(self,
                 predictor: Predictor | None = None,
                 cost_model: CostModel | None = None,
                 policy: "Policy | str | None" = None,
                 bucket_size: int = 200,
                 noise_weight: float = 0.0,
                 noise_max_len: int = 4096,
                 priority_backend="numpy",
                 batch_k: int = 8,
                 max_batch_k: int = 256,
                 posterior_quantile: float | None = None,
                 calibration: CalibrationMonitor | None = None,
                 conformal_widening: bool = True,
                 degraded_exit_successes: int = 4,
                 clock=time.monotonic):
        self.predictor = predictor or SemanticHistoryPredictor()
        self.cost_model = cost_model or ResourceBoundCost()
        if isinstance(policy, str):
            policy = make_policy(policy)
        self.policy = policy or SageSchedPolicy()
        self.bucket_size = max(1, bucket_size)
        self.noise_weight = noise_weight  # Fig. 11 robustness experiment
        self.noise_max_len = noise_max_len
        self.clock = clock
        self.backend = make_priority_backend(priority_backend)
        self._state = BatchState(k=batch_k, max_k=max_batch_k) \
            if self.backend is not None else None
        if getattr(self.policy, "rank_based", False) and self._state is None:
            raise ValueError(
                f"policy {self.policy.name!r} blends ranks over the whole "
                "live set and needs an array backend; "
                "priority_backend='object' has no batch view to rank over")
        # mid-flight posterior updates: truncate a request's stored
        # length/cost beliefs once it decodes past this quantile of its
        # own predicted length distribution (None = frozen-at-admission
        # beliefs)
        if posterior_quantile is not None \
                and not 0.0 < posterior_quantile < 1.0:
            raise ValueError(
                f"posterior_quantile must be in (0, 1), got "
                f"{posterior_quantile!r}")
        self._posterior_q = posterior_quantile
        self.calibration = calibration if calibration is not None \
            else CalibrationMonitor()
        self.conformal_widening = bool(conformal_widening)
        # degraded-mode exit hysteresis: this many consecutive successful
        # predictions before trusting the predictor again (a single good
        # call after an outage must not flap the gateway's static limits)
        self.degraded_exit_successes = max(1, int(degraded_exit_successes))
        self._pred_ok_streak = 0
        self._live: dict[str, ScheduledRequest] = {}
        self._arrival_seq = 0  # tie-break for identical clock readings
        self._now = 0.0
        self.stats = {"predictions": 0, "refreshes": 0, "completions": 0,
                      "prediction_failures": 0, "posterior_updates": 0,
                      "conformal_widenings": 0}
        self.degraded = False  # last predictor call failed (see admit_batch)
        self._fallback_dist: LengthDistribution | None = None

    # ------------------------------------------------------------- lifecycle

    def _prediction_free_prior(self) -> LengthDistribution:
        """Static fallback when the predictor is unavailable: a flat
        prior over a coarse length grid up to ``noise_max_len``.  Every
        request gets the SAME distribution, so no request is ranked on
        (stale or corrupt) per-request information."""
        if self._fallback_dist is None:
            grid = np.unique(np.linspace(
                1, max(2, self.noise_max_len), 16).astype(np.int64))
            self._fallback_dist = LengthDistribution(
                grid, np.full(grid.size, 1.0 / grid.size))
        return self._fallback_dist

    def admit(self, request_id: str, prompt: str, input_len: int,
              arrival: float | None = None,
              node_id: int = -1, length_dist=None,
              tenant: str = "default") -> ScheduledRequest:
        """Register one arriving request — the B = 1 case of
        ``admit_batch`` (batch is the primitive; scalar is sugar).

        ``node_id`` tags the request with its serving node (cluster mode,
        see repro.simulator.cluster, not yet ported); ``order(node_id=...)`` then ranks
        one node's queue as a masked lexsort over the shared state.
        ``length_dist`` short-circuits the predictor with an already-
        computed prediction (e.g. the cost-aware router's route-time
        lookup) so the semantic-history search is not paid twice.
        ``tenant`` keys the calibration monitor's rolling statistics."""
        return self.admit_batch(
            [request_id], [prompt], [input_len],
            arrivals=None if arrival is None else [arrival],
            node_ids=node_id,
            length_dists=None if length_dist is None else [length_dist],
            tenants=[tenant])[0]

    def admit_batch(self, request_ids, prompts, input_lens, *,
                    arrivals=None, node_ids=-1,
                    length_dists=None, tenants=None) -> list[ScheduledRequest]:
        """Admit a burst of arrivals in one batched pass: one
        ``predict_batch`` over the (unique) prompts, one cost-model
        pushforward sweep, one ``BatchState.add_batch`` append (single
        capacity grow), and one vectorized initial-priority evaluation.
        Bit-identical to the equivalent sequence of scalar ``admit``
        calls — asserted column-for-column in tests/test_batch_ingress.py.

        ``arrivals=None`` stamps the whole burst with ONE clock reading
        (a scalar-admit loop would read the clock per request — pass
        explicit arrivals when that distinction matters).  ``node_ids``
        is a scalar or per-request sequence.  ``length_dists`` may carry
        route-time predictions; ``None`` entries are predicted here, in
        one batched call.  Duplicate request ids (against live state or
        within the burst) raise before any state is mutated.
        """
        rids = list(request_ids)
        b = len(rids)
        if b == 0:
            return []
        seen: set[str] = set()
        for rid in rids:
            if rid in self._live or rid in seen:
                raise KeyError(f"request {rid!r} already admitted")
            seen.add(rid)
        prompts = list(prompts)
        input_lens = [int(il) for il in input_lens]
        if arrivals is None:
            now = self.clock()
            arrivals = [now] * b
        else:
            arrivals = [float(a) for a in arrivals]
        if np.ndim(node_ids) == 0:
            node_ids = [int(node_ids)] * b
        else:
            node_ids = [int(nd) for nd in node_ids]
        length_dists = [None] * b if length_dists is None \
            else list(length_dists)
        tenants = ["default"] * b if tenants is None \
            else [str(t) for t in tenants]
        missing = [j for j in range(b) if length_dists[j] is None]
        degraded_fill: set[int] = set()
        if missing:
            # predict_many: the batched path when it is authoritative for
            # this predictor class, else a scalar-predict loop (honors
            # subclasses that override only the scalar method)
            try:
                preds = self.predictor.predict_many(
                    [prompts[j] for j in missing],
                    [input_lens[j] for j in missing])
                # exit hysteresis: one healthy call after an outage must
                # not flap the degraded flag (and with it the gateway's
                # static limits); require a streak of clean predictions
                self._pred_ok_streak += len(missing)
                if self.degraded \
                        and self._pred_ok_streak >= self.degraded_exit_successes:
                    self.degraded = False
            except Exception:
                # predictor / history store down: degrade to a static
                # prediction-free prior instead of failing admission —
                # Gittins over a flat prior carries no per-request
                # information, so ordering falls back to arrival-driven
                # behavior; the gateway reads ``degraded`` and switches
                # its shed policy to FCFS tail-drop + static limits
                self.stats["prediction_failures"] += len(missing)
                self.degraded = True
                self._pred_ok_streak = 0
                preds = [self._prediction_free_prior() for _ in missing]
                degraded_fill = set(missing)
            for j, d in zip(missing, preds):
                length_dists[j] = d
            self.stats["predictions"] += len(missing)
        # the pristine admission-time prediction, captured BEFORE any
        # widening / noise mixing: completion-time scoring (calibration,
        # hedge weights) must grade the predictor's own output, not the
        # scheduler's defensive transformations of it.  Degraded-mode
        # priors carry no per-request information — nothing to grade.
        pred_dists = [None if j in degraded_fill else length_dists[j]
                      for j in range(b)]
        if self.conformal_widening:
            # conformal widening: tenants whose realized lengths have
            # been escaping the predicted coverage band get their next
            # admissions mixed toward the flat prior (deterministic, so
            # batch/scalar admission parity is preserved)
            wcache: dict[str, float] = {}
            for j in range(b):
                if j in degraded_fill:
                    continue
                t = tenants[j]
                w = wcache.get(t)
                if w is None:
                    w = wcache[t] = self.calibration.widen_weight(t)
                if w > 0.0:
                    length_dists[j] = length_dists[j].mix_uniform(
                        w, self.noise_max_len)
                    self.stats["conformal_widenings"] += 1
        if self.noise_weight > 0.0:  # Fig. 11 robustness experiment
            length_dists = [ld.mix_uniform(self.noise_weight,
                                           self.noise_max_len)
                            for ld in length_dists]
        cost_dists = self.cost_model.distribution_batch(input_lens,
                                                        length_dists)
        q = self._posterior_q
        srs: list[ScheduledRequest] = []
        for j in range(b):
            # encode arrival order into the float so FCFS ties stay stable
            self._arrival_seq += 1
            sr = ScheduledRequest(
                request_id=rids[j], prompt=prompts[j],
                input_len=input_lens[j],
                arrival=arrivals[j] + self._arrival_seq * 1e-9,
                length_dist=length_dists[j], cost_dist=cost_dists[j],
                node_id=node_ids[j], tenant=tenants[j],
                pred_dist=pred_dists[j])
            if q is not None:
                # first mid-flight posterior trigger: the q-quantile of
                # the stored (post-widening) belief
                sr.posterior_cut = float(length_dists[j].quantile(q))
            srs.append(sr)
        pol = self.policy
        rank_based = getattr(pol, "rank_based", False)
        st = self._state
        for sr in srs:
            self._live[sr.request_id] = sr
        if st is None:
            for sr in srs:  # object backend: the eager scalar oracle
                sr.priority = pol.priority(sr)
                sr.next_refresh = pol.next_boundary(sr, self.bucket_size)
            return srs
        if b == 1 and not rank_based:
            # single admission: direct scalar writes, no index arrays —
            # this keeps the ``admit`` sugar as cheap as the pre-batch
            # scalar path for non-bursty callers
            sr = srs[0]
            aging = getattr(pol, "time_varying", False) \
                and hasattr(pol, "base_priority") \
                and hasattr(pol, "apply_age")
            if aging:
                # one index evaluation, not two: derive the discounted
                # priority from the cached base instead of recomputing
                base = pol.base_priority(sr)
                sr.priority = float(pol.apply_age(
                    base, sr.arrival, getattr(pol, "now", self._now)))
            else:
                sr.priority = pol.priority(sr)
                base = sr.priority
            sr.next_refresh = pol.next_boundary(sr, self.bucket_size)
            i = st.add(sr.request_id, sr.cost_dist, sr.length_dist,
                       arrival=sr.arrival, input_len=sr.input_len,
                       next_refresh=sr.next_refresh, priority=sr.priority,
                       base_priority=base, node_id=sr.node_id)
            st.posterior_cut[i] = sr.posterior_cut
            return srs
        if pol.has_boundary_batch:
            nrefresh = pol.next_boundary_batch(np.zeros(b, np.int64),
                                               self.bucket_size)
        else:
            nrefresh = np.array([pol.next_boundary(sr, self.bucket_size)
                                 for sr in srs], np.float64)
        for sr, nr in zip(srs, nrefresh):
            sr.next_refresh = float(nr)
        idx = st.add_batch(
            rids, cost_dists, length_dists,
            arrivals=[sr.arrival for sr in srs], input_lens=input_lens,
            next_refreshes=nrefresh, priorities=np.zeros(b),
            base_priorities=np.zeros(b), node_ids=node_ids)
        st.posterior_cut[idx] = [sr.posterior_cut for sr in srs]
        base, prio = self._admission_priorities(srs, idx)
        st.base_priority[idx] = base
        st.priority[idx] = prio
        for sr, p in zip(srs, prio):
            sr.priority = float(p)
        if rank_based:
            # rank-blending policies score against the WHOLE live set:
            # any membership change invalidates every cached priority
            st.dirty[:st.n] = True
        return srs

    def _admission_priorities(self, srs, idx: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Initial (base, priority) vectors for freshly admitted rows.

        Bursts go through the policy's batched path when it has one; the
        batched evaluators run on ``_ADMIT_BACKEND`` (float64 numpy)
        regardless of the configured refresh backend, because admission
        priorities are defined against the scalar oracle — the numpy
        batch path is engineered bit-identical to it, while e.g. the
        float32 CUDA kernel is not.  Scalar admits (B = 1) and
        policies without a batch path take the scalar oracle directly.
        """
        pol = self.policy
        st = self._state
        aging = getattr(pol, "time_varying", False) \
            and hasattr(pol, "base_priority") and hasattr(pol, "apply_age")
        now = getattr(pol, "now", self._now)
        if aging:
            if pol.has_batch and hasattr(pol, "base_priority_batch"):
                base = np.asarray(pol.base_priority_batch(
                    st.view(idx), _ADMIT_BACKEND), np.float64)
            else:
                # one index evaluation, not two: derive the discounted
                # priority from the cached base instead of recomputing
                base = np.array([pol.base_priority(sr) for sr in srs],
                                np.float64)
            return base, np.asarray(pol.apply_age(base, st.arrival[idx],
                                                  now), np.float64)
        if pol.has_batch:
            prio = np.asarray(pol.priority_batch(st.view(idx),
                                                 _ADMIT_BACKEND), np.float64)
        else:
            prio = np.array([pol.priority(sr) for sr in srs], np.float64)
        return prio, prio

    def assign_node(self, request_id: str, node_id: int) -> None:
        """(Re-)bind a live request to a serving node — the router's write
        path (initial placement, or migration between nodes)."""
        sr = self._live[request_id]
        sr.node_id = node_id
        if self._state is not None:
            self._state.node_id[self._state.index[request_id]] = node_id

    def outstanding_by_node(self, n_nodes: int) -> np.ndarray:
        """(n_nodes,) predicted *remaining* cost per node: one masked
        bincount over the shared state (admission-time cost mean minus
        attained cost, floored at 0).  Rows with ``node_id`` outside
        [0, n_nodes) — unassigned requests — are excluded.  This is the
        cluster-introspection surface (load dashboards, migration
        policies); ``CostAwareRouter`` keeps its own admit-time
        accounting instead, so routing decisions stay identical between
        shared-state and per-node-fanout modes and cover requests that
        are routed but not yet admitted."""
        st = self._state
        if st is None:
            out = np.zeros(n_nodes)
            for sr in self._live.values():
                if 0 <= sr.node_id < n_nodes:
                    out[sr.node_id] += max(
                        sr.cost_dist.mean - sr.attained_cost, 0.0)
            return out
        self.refresh()
        nid = st.node_id[:st.n]
        ok = (nid >= 0) & (nid < n_nodes)
        rem = np.maximum(st.cost_mean[:st.n] - st.attained[:st.n], 0.0)
        return np.bincount(nid[ok], weights=rem[ok], minlength=n_nodes)

    def on_progress(self, request_id: str, generated: int) -> None:
        """Report that ``generated`` output tokens now exist.  Under a
        batched backend this only *marks the row dirty* when it crosses
        its refresh boundary; the recomputation happens wholesale in
        ``refresh()``.  The object backend keeps the original eager
        per-request recompute (cost buckets for SageSched, quantum edges
        for FastServe)."""
        sr = self._live[request_id]
        if generated == sr.generated:
            return
        sr.generated = generated
        q = self._posterior_q
        st = self._state
        if st is not None:
            i = st.index[request_id]
            st.generated[i] = generated
            if (self.policy.refreshing and generated >= st.next_refresh[i]) \
                    or (q is not None and generated >= st.posterior_cut[i]):
                st.dirty[i] = True
            return
        refresh_due = self.policy.refreshing and generated >= sr.next_refresh
        posterior_due = q is not None and generated >= sr.posterior_cut
        if not (refresh_due or posterior_due):
            return
        sr.attained_cost = self.cost_model.attained(sr.input_len, generated)
        if posterior_due:
            # object backend truncates eagerly; the batched backend does
            # the same work wholesale in refresh().  Both paths see one
            # progress batch per refresh in the engine/simulator loops,
            # so chained truncations stay bit-identical.
            self._posterior_scalar(sr)
        sr.priority = self.policy.priority(sr)
        sr.next_refresh = self.policy.next_boundary(sr, self.bucket_size)
        self.stats["refreshes"] += 1

    def on_progress_many(self, request_ids, generated) -> None:
        """Vectorized ``on_progress`` over parallel id/count sequences:
        one fancy-indexed write + dirty-mark under a batched backend."""
        st = self._state
        if st is None:
            for rid, g in zip(request_ids, generated):
                self.on_progress(rid, int(g))
            return
        ids = list(request_ids)
        if not ids:
            return
        idx = np.fromiter((st.index[r] for r in ids), np.int64, len(ids))
        gens = np.asarray(generated, np.int64)
        st.generated[idx] = gens
        if self.policy.refreshing:
            st.dirty[idx] |= gens >= st.next_refresh[idx]
        if self._posterior_q is not None:
            st.dirty[idx] |= gens >= st.posterior_cut[idx]

    def refresh(self) -> int:
        """Recompute every dirty priority in one batched pass.  Returns
        the number of rows refreshed.  No-op on the object backend (it
        refreshes eagerly in ``on_progress``)."""
        st = self._state
        if st is None or st.n == 0:
            return 0
        d = st.dirty[:st.n]
        if not d.any():
            return 0
        pol = self.policy
        idx = np.flatnonzero(d)
        if getattr(pol, "rank_based", False):
            # rank blending is a function of the whole live set — one
            # dirty row means every rank can shift
            idx = np.arange(st.n)
        st.dirty[:st.n] = False
        st.attained[idx] = self.cost_model.attained_batch(
            st.input_len[idx], st.generated[idx])
        if self._posterior_q is not None:
            self._posterior_update(idx)
        if pol.has_batch:
            view = st.view(idx)
            if getattr(pol, "time_varying", False) \
                    and hasattr(pol, "base_priority_batch"):
                base = pol.base_priority_batch(view, self.backend)
                st.base_priority[idx] = base
                st.priority[idx] = pol.apply_age(base, st.arrival[idx],
                                                 self._now)
            else:
                st.priority[idx] = pol.priority_batch(view, self.backend)
        else:
            # scalar fallback: custom policies without a batch path
            for i in idx:
                sr = self._live[st.ids[i]]
                sr.generated = int(st.generated[i])
                sr.attained_cost = float(st.attained[i])
                st.priority[i] = pol.priority(sr)
        if not pol.has_boundary_batch:
            # custom scalar boundary without a batch override: honor it
            for i in idx:
                sr = self._live[st.ids[i]]
                sr.generated = int(st.generated[i])
                st.next_refresh[i] = pol.next_boundary(sr, self.bucket_size)
        else:
            st.next_refresh[idx] = pol.next_boundary_batch(
                st.generated[idx], self.bucket_size)
        self.stats["refreshes"] += int(idx.size)
        return int(idx.size)

    # ------------------------------------------------- mid-flight posteriors

    def _posterior_fallback(self, generated: int) -> LengthDistribution:
        """Tail belief for a request that has outrun its ENTIRE predicted
        support: a flat prior over a grid reaching past the current
        position (never NaN, never zero-mass — ``mix_uniform(1.0, ...)``
        lays a uniform grid up to at least 2x the attained length, and
        ``truncate`` keeps its strictly-larger points)."""
        point = LengthDistribution(np.array([generated + 1], np.int64),
                                   np.array([1.0]))
        flat = point.mix_uniform(
            1.0, max(self.noise_max_len, 2 * (generated + 1)))
        out = flat.truncate(generated)
        assert out is not None  # grid max > generated by construction
        return out

    def _posterior_scalar(self, sr: ScheduledRequest) -> None:
        """Object-backend posterior update: condition the stored beliefs
        on (length > generated, cost > attained) via the compact
        ``truncate`` oracles; the batched ``_posterior_update`` is
        engineered bit-identical to this."""
        g = int(sr.generated)
        new_len = sr.length_dist.truncate(g)
        new_cost = sr.cost_dist.truncate(sr.attained_cost)
        if new_len is None or new_cost is None:
            # prediction exhausted: rebuild from the flat tail prior
            new_len = self._posterior_fallback(g)
            new_cost = self.cost_model.distribution(
                sr.input_len, new_len.lengths, new_len.probs)
        sr.length_dist = new_len
        sr.cost_dist = new_cost
        sr.posterior_cut = float(new_len.quantile(self._posterior_q))
        self.stats["posterior_updates"] += 1

    def _posterior_update(self, idx: np.ndarray) -> None:
        """Batched posterior update over the rows in ``idx`` that crossed
        their posterior cut: ONE vectorized ``truncate_rows`` pass over
        the (n, k) length and cost blocks (supports stay absolute; dead
        columns carry exact-0 probs, inert to every batched consumer),
        then a vectorized requantile for the next cut.  Rows whose whole
        predicted mass is already behind them fall back to the same
        scalar flat-tail rebuild as the object backend.  Requires
        ``st.attained`` to be current for the rows (refresh() updates it
        first)."""
        st = self._state
        q = self._posterior_q
        hit = st.generated[idx] >= st.posterior_cut[idx]
        if not hit.any():
            return
        rows = idx[hit]
        gens = st.generated[rows].astype(np.float64)
        new_len, len_ex = truncate_rows(st.len_sup[rows],
                                        st.len_probs[rows], gens)
        new_cost, cost_ex = truncate_rows(st.cost_sup[rows],
                                          st.cost_probs[rows],
                                          st.attained[rows])
        ex = len_ex | cost_ex
        ok_rows = rows[~ex]
        if ok_rows.size:
            st.len_probs[ok_rows] = new_len[~ex]
            st.cost_probs[ok_rows] = new_cost[~ex]
            # sequential cumsum mean / quantile: bit-identical to the
            # scalar oracles (dead columns add exact 0.0)
            st.cost_mean[ok_rows] = np.cumsum(
                st.cost_sup[ok_rows] * st.cost_probs[ok_rows],
                axis=1)[:, -1]
            cdf = np.cumsum(st.len_probs[ok_rows], axis=1)
            qi = np.minimum((cdf < q).sum(axis=1), st.k - 1)
            st.posterior_cut[ok_rows] = st.len_sup[
                ok_rows, qi]
        for i in rows[ex]:
            g = int(st.generated[i])
            ld = self._posterior_fallback(g)
            cd = self.cost_model.distribution(int(st.input_len[i]),
                                              ld.lengths, ld.probs)
            k_needed = max(ld.lengths.shape[0], cd.support.shape[0])
            if k_needed > st.k:
                st._grow_cols(k_needed)
            st._write_row(st.len_sup, st.len_probs, i, ld.lengths, ld.probs)
            st._write_row(st.cost_sup, st.cost_probs, i,
                          cd.support, cd.probs)
            st.cost_mean[i] = cd.mean
            st.posterior_cut[i] = float(ld.quantile(q))
        self.stats["posterior_updates"] += int(rows.size)

    def tokens_to_refresh(self, request_id: str) -> float:
        """Output tokens until this request's next priority refresh OR
        posterior update, whichever comes first (simulator fast-forward
        bound — fast-forwarding past a posterior cut would skip the
        belief update that reorders the queue)."""
        st = self._state
        if st is not None:
            self.refresh()
            i = st.index[request_id]
            bound = st.next_refresh[i]
            if self._posterior_q is not None:
                bound = min(bound, st.posterior_cut[i])
            return float(bound - st.generated[i])
        sr = self._live[request_id]
        bound = sr.next_refresh
        if self._posterior_q is not None:
            bound = min(bound, sr.posterior_cut)
        return bound - sr.generated

    def min_tokens_to_refresh(self, request_ids) -> float:
        """Vectorized min over ``tokens_to_refresh`` (simulator hot path)."""
        st = self._state
        if st is None:
            return min(self.tokens_to_refresh(r) for r in request_ids)
        self.refresh()
        idx = np.fromiter((st.index[r] for r in request_ids), np.int64,
                          len(request_ids))
        bounds = st.next_refresh[idx]
        if self._posterior_q is not None:
            bounds = np.minimum(bounds, st.posterior_cut[idx])
        return float(np.min(bounds - st.generated[idx]))

    def on_complete(self, request_id: str, output_len: int) -> None:
        """Request finished: feed the predictor's history, grade the
        admission-time prediction (calibration window + hedge weights)
        and drop state."""
        sr = self._live.pop(request_id)
        self.predictor.observe(sr.prompt, sr.input_len, output_len)
        if sr.pred_dist is not None:
            self.calibration.observe(sr.tenant, sr.pred_dist, output_len)
        if hasattr(self.policy, "observe_outcome"):
            # hedging controllers race their experts on realized error;
            # pred_dist=None (degraded-mode prior) is a no-op for them
            self.policy.observe_outcome(sr.pred_dist, output_len)
            self.stats["hedge"] = self.policy.snapshot()
        if self._state is not None:
            self._state.remove(request_id)
            if getattr(self.policy, "rank_based", False) and self._state.n:
                self._state.dirty[:self._state.n] = True
        self.stats["completions"] += 1

    def on_abort(self, request_id: str) -> None:
        if self._live.pop(request_id, None) is not None \
                and self._state is not None:
            self._state.remove(request_id)
            if getattr(self.policy, "rank_based", False) and self._state.n:
                self._state.dirty[:self._state.n] = True

    # ------------------------------------------------------------- queries

    def get(self, request_id: str) -> ScheduledRequest:
        sr = self._live[request_id]
        st = self._state
        if st is not None:
            self.refresh()
            i = st.index[request_id]
            sr.generated = int(st.generated[i])
            sr.priority = float(st.priority[i])
            sr.attained_cost = float(st.attained[i])
            sr.next_refresh = float(st.next_refresh[i])
            sr.posterior_cut = float(st.posterior_cut[i])
        return sr

    def __contains__(self, request_id: str) -> bool:
        return request_id in self._live

    def __len__(self) -> int:
        return len(self._live)

    @property
    def preemptive(self) -> bool:
        return self.policy.preemptive

    @property
    def posterior_quantile(self) -> float | None:
        return self._posterior_q

    @property
    def runtime_refreshing(self) -> bool:
        """Whether per-iteration progress can change priorities: true for
        refreshing policies AND whenever mid-flight posteriors are on (a
        posterior cut reorders the queue even under a frozen policy) —
        the simulator keys its fast-forward decision on this, not on
        ``policy.refreshing`` alone."""
        return self.policy.refreshing or self._posterior_q is not None

    def calibration_summary(self) -> dict:
        """Per-tenant rolling calibration table (see
        ``robust.CalibrationMonitor.summary``) — the surface the engine
        metrics and the gateway summary re-export."""
        return self.calibration.summary()

    def set_now(self, now: float) -> None:
        """Inject the current (sim or wall) time; time-varying policies
        (aging) re-apply their discount — a single vectorized pass under
        a batched backend, no index recomputation."""
        self._now = now
        if not getattr(self.policy, "time_varying", False):
            return
        self.policy.now = now
        st = self._state
        if st is None:
            for sr in self._live.values():
                sr.priority = self.policy.priority(sr)
            return
        if not st.n:
            return
        self.refresh()
        pol = self.policy
        # the vectorized discount is only valid when refresh() maintains
        # st.base_priority — i.e. the policy has the full batched aging
        # surface; otherwise the cached base is stale admit-time data
        if hasattr(pol, "apply_age") and hasattr(pol, "base_priority_batch") \
                and pol.has_batch:
            st.priority[:st.n] = pol.apply_age(
                st.base_priority[:st.n], st.arrival[:st.n], now)
        else:  # scalar-only time-varying policy: loop the oracle
            for i in range(st.n):
                sr = self._live[st.ids[i]]
                sr.generated = int(st.generated[i])
                sr.attained_cost = float(st.attained[i])
                st.priority[i] = pol.priority(sr)

    def order(self, request_ids=None, *, running=None,
              hysteresis: float = 1.0, pin_running: bool = False,
              node_id: int | None = None) -> list[str]:
        """Request ids sorted by priority (smaller first, arrival ties).

        running/hysteresis/pin_running implement the callers' admission
        semantics in one place: ids in ``running`` either get their
        priority scaled by ``hysteresis`` (preemptive anti-thrashing,
        Sec. 3.3) or pinned ahead of everything (``pin_running``,
        non-preemptive engines).  Under a batched backend this is one
        ``np.lexsort`` over the state arrays.

        node_id restricts the ranking to one serving node's requests — a
        masked lexsort over the cluster-shared state (ignored when
        ``request_ids`` is given explicitly).
        """
        st = self._state
        if st is None:
            return self._order_object(request_ids, running, hysteresis,
                                      pin_running, node_id)
        self.refresh()
        if request_ids is None and node_id is not None:
            nidx = np.flatnonzero(st.node_id[:st.n] == node_id)
            ids = [st.ids[i] for i in nidx]
            prio = st.priority[nidx]
            arr = st.arrival[nidx]
        elif request_ids is None:
            ids = st.ids[:st.n]
            prio = st.priority[:st.n].copy()
            arr = st.arrival[:st.n]
        else:
            ids = list(request_ids)
            idx = np.fromiter((st.index[r] for r in ids), np.int64, len(ids))
            prio = st.priority[idx]
            arr = st.arrival[idx]
        if running:
            rmask = np.fromiter((r in running for r in ids), bool, len(ids))
            if pin_running:
                prio[rmask] = -np.inf
            else:
                prio[rmask] *= hysteresis
        # permute through an object array: ~10x faster than indexing a
        # python list with numpy int64 scalars at 10k-deep queues
        id_arr = np.empty(len(ids), object)
        id_arr[:] = ids
        return id_arr[np.lexsort((arr, prio))].tolist()

    def eviction_order(self, request_ids, *, held_tokens,
                       swap_cost=None, memory_weight: float = 0.0
                       ) -> list[str]:
        """Rank ``request_ids`` for *capacity-forced eviction*: the first
        id is the best victim.  With ``memory_weight = 0`` this is
        exactly ``order()`` reversed (evict the least urgent — the vLLM
        baseline).  A positive weight adds the paper's memory half of the
        hybrid service cost: among similarly-urgent candidates, prefer
        victims whose KV is cheap to restore (small held footprint /
        swap IO), because the preemption's true cost includes paying
        that IO on readmission.  Shared by the real engine and the
        simulator so both layers evict under ONE preemption cost model.

        held_tokens: mapping rid -> resident KV tokens the eviction
        would actually free.  Under copy-on-write prefix sharing the
        engine passes *owned* (refcount-weighted) tokens —
        ``KVCacheManager.owned_tokens_of`` — so a request holding a
        widely shared prefix ranks as a cheap-to-keep victim: evicting
        it frees almost nothing.  Fractional values are fine (the math
        below is float throughout); for private allocations owned ==
        block-aligned held tokens and the ranking is unchanged.
        swap_cost: callable tokens -> predicted restore cost (e.g.
        ``ServiceModel.swap_time``); None falls back to held tokens
        (∝ KV bytes) as the proxy — swap_time is affine in bytes, so
        the ranking is identical whenever every candidate shares one
        node spec.
        """
        ids = list(request_ids)
        if not ids:
            return []
        ordered = self.order(ids)            # most urgent first
        if memory_weight <= 0.0 or len(ids) == 1:
            return ordered[::-1]
        rank = {rid: j for j, rid in enumerate(ordered)}
        ranks = np.fromiter((rank[r] for r in ids), np.float64, len(ids))
        held = np.fromiter((float(held_tokens[r]) for r in ids),
                           np.float64, len(ids))
        costs = np.array([swap_cost(t) for t in held], np.float64) \
            if swap_cost is not None else held
        scores = eviction_scores(ranks, costs, memory_weight)
        # ties (same score) break toward the less urgent candidate
        sort = np.lexsort((-ranks, -scores))
        return [ids[i] for i in sort]

    def _order_object(self, request_ids, running, hysteresis,
                      pin_running, node_id=None) -> list[str]:
        if request_ids is None:
            srs = [sr for sr in self._live.values()
                   if node_id is None or sr.node_id == node_id]
        else:
            srs = [self._live[r] for r in request_ids]
        if running:
            if pin_running:
                srs.sort(key=lambda s: (
                    (-np.inf, s.arrival) if s.request_id in running
                    else (s.priority, s.arrival)))
            else:
                srs.sort(key=lambda s: (
                    s.priority * (hysteresis if s.request_id in running
                                  else 1.0), s.arrival))
        else:
            srs.sort(key=lambda s: (s.priority, s.arrival))
        return [s.request_id for s in srs]
