"""Scheduling policies: SageSched and every baseline the paper compares.

A policy maps a request's scheduler-side state to a scalar *priority*
(smaller = served first).  The Scheduler (scheduler.py) owns state updates
and bucketized refresh; policies are pure priority functions plus two
capability flags:

  * ``preemptive``   — may a running request be displaced by a smaller
                        priority arrival?
  * ``refreshing``   — does the priority depend on runtime progress (and
                        hence need recomputation at bucket boundaries)?

Implemented policies (paper Sec. 2.2 / 4.1 / 4.3.3):

  fcfs        FCFS, vLLM/SGLang default (Kwon et al. 2023).
  fastserve   MLFQ with exponentially growing quantums approximating SRPT
              without predictions (Wu et al. 2023).
  ssjf        Shortest-Job-First on a *point* output-length prediction
              (Qiu et al. 2024).
  ltr         Learning-to-rank: relative order of predicted lengths
              (Fu et al. 2024) — rank-preserving point estimate.
  trail       SRPT-approx with per-bucket re-predicted remaining length
              (Shahout et al. 2025).
  mean        Expected remaining *cost* (ablation, Fig. 6/11 'Mean').
  gittins     Gittins index at admission, never refreshed (ablation).
  sagesched   Gittins index + runtime bucket refresh — the paper's policy.
  hedged      Online hedge between a prediction-trusting ordering and a
              prediction-free one, multiplicative weights updated from
              realized prediction error (arXiv:2508.14544 playbook).
"""

from __future__ import annotations

import numpy as np

from .gittins import gittins_index, mean_index
from .robust import prediction_loss

__all__ = ["Policy", "HedgedPolicy", "make_policy", "POLICY_NAMES"]


class Policy:
    """Scalar interface (``priority``) plus the batched interface
    (``priority_batch``) used by the array-native scheduler hot path.

    ``priority_batch`` receives a *view* — a struct of parallel arrays
    (see ``repro_torch.core.backends.BatchView``): ``cost_sup``/``cost_probs``
    and ``len_sup``/``len_probs`` as (n, k) bucketized distributions
    (padded entries carry prob 0), ``generated``/``attained``/``arrival``/
    ``input_len`` as (n,) vectors — and a backend exposing batched
    ``gittins``/``mean`` evaluators.  It returns the (n,) priorities in
    one fused pass; the scalar ``priority`` remains the oracle it is
    property-tested against.
    """

    name = "base"
    preemptive = False
    refreshing = False
    time_varying = False   # priority depends on wall/sim time (aging)

    def priority(self, sr) -> float:  # sr: scheduler.ScheduledRequest
        raise NotImplementedError

    def priority_batch(self, view, backend) -> np.ndarray:
        """Batched priorities; subclasses override with vectorized math.
        (The Scheduler falls back to the scalar path for policies that
        don't.)"""
        raise NotImplementedError

    @property
    def has_batch(self) -> bool:
        """True when the batch path is trustworthy: ``priority_batch``
        must be defined at (or below) the class that defines the scalar
        ``priority`` in the MRO.  A subclass that overrides only the
        scalar falls back to it — an inherited ``priority_batch`` would
        silently disagree with the override."""
        cls = type(self)
        if cls.priority_batch is Policy.priority_batch:
            return False
        pb = next(c for c in cls.__mro__ if "priority_batch" in c.__dict__)
        pr = next((c for c in cls.__mro__ if "priority" in c.__dict__),
                  Policy)
        return issubclass(pb, pr)

    @property
    def has_boundary_batch(self) -> bool:
        """Same MRO rule for the refresh-boundary pair: the vectorized
        ``next_boundary_batch`` is used only if it is defined at or
        below the scalar ``next_boundary`` override."""
        cls = type(self)
        nb = next(c for c in cls.__mro__
                  if "next_boundary_batch" in c.__dict__)
        ns = next(c for c in cls.__mro__ if "next_boundary" in c.__dict__)
        return issubclass(nb, ns)

    def next_boundary(self, sr, bucket_size: int) -> float:
        """Generated-token count at which the priority must next be
        recomputed.  Default: the paper's cost-bucket boundaries."""
        if not self.refreshing:
            return float("inf")
        return (sr.generated // bucket_size + 1) * bucket_size

    def next_boundary_batch(self, generated: np.ndarray, bucket_size: int
                            ) -> np.ndarray:
        if not self.refreshing:
            return np.full(np.asarray(generated).shape[0], np.inf)
        g = np.asarray(generated, np.int64)
        return ((g // bucket_size + 1) * bucket_size).astype(np.float64)


class FCFSPolicy(Policy):
    name = "fcfs"

    def priority(self, sr) -> float:
        return sr.arrival

    def priority_batch(self, view, backend) -> np.ndarray:
        return view.arrival.astype(np.float64, copy=True)


class FastServePolicy(Policy):
    """MLFQ: requests enter the top queue; after consuming the level's
    quantum of service they are demoted.  Priority = (level, arrival).
    Levels are encoded into one float: level * LEVEL_SPAN + arrival_rank."""

    name = "fastserve"
    preemptive = True
    refreshing = True
    LEVEL_SPAN = 1e12

    def __init__(self, base_quantum: int = 64, n_levels: int = 8):
        self.base_quantum = base_quantum
        self.n_levels = n_levels

    def _cum_budgets(self) -> np.ndarray:
        q = self.base_quantum * (2 ** np.arange(self.n_levels, dtype=np.int64))
        return np.cumsum(q)

    def level_of(self, service_tokens: int) -> int:
        """MLFQ level after ``service_tokens`` tokens of service: quantum of
        level k is base_quantum * 2^k; demote when cumulative budget spent."""
        budget, q = 0, self.base_quantum
        for level in range(self.n_levels):
            budget += q
            if service_tokens < budget:
                return level
            q *= 2
        return self.n_levels - 1

    def priority(self, sr) -> float:
        return self.level_of(sr.generated) * self.LEVEL_SPAN + sr.arrival

    def priority_batch(self, view, backend) -> np.ndarray:
        cum = self._cum_budgets()
        g = np.asarray(view.generated, np.int64)
        level = np.minimum(np.searchsorted(cum, g, side="right"),
                           self.n_levels - 1)
        return level.astype(np.float64) * self.LEVEL_SPAN + view.arrival

    def next_boundary(self, sr, bucket_size: int) -> float:
        """Demotion happens at cumulative quantum boundaries, not at the
        Gittins cost buckets."""
        budget, q = 0, self.base_quantum
        for _ in range(self.n_levels):
            budget += q
            if sr.generated < budget:
                return budget
            q *= 2
        return float("inf")

    def next_boundary_batch(self, generated, bucket_size: int) -> np.ndarray:
        cum = self._cum_budgets().astype(np.float64)
        g = np.asarray(generated, np.int64)
        idx = np.searchsorted(cum, g, side="right")
        return np.concatenate([cum, [np.inf]])[idx]


class SSJFPolicy(Policy):
    """Non-preemptive SJF on the predicted mean output length."""

    name = "ssjf"

    def priority(self, sr) -> float:
        return sr.length_dist.mean

    def priority_batch(self, view, backend) -> np.ndarray:
        lp = view.len_probs
        return np.cumsum(np.where(lp > 0, view.len_sup * lp, 0.0),
                         axis=1)[:, -1]


class LTRPolicy(Policy):
    """Learning-to-rank: only the relative order matters; we use the
    predicted median, which is what a rank model recovers (Fu et al. 2024
    optimize Kendall's tau against the true length order)."""

    name = "ltr"

    def priority(self, sr) -> float:
        return float(sr.length_dist.quantile(0.5))

    def priority_batch(self, view, backend) -> np.ndarray:
        cdf = np.cumsum(view.len_probs, axis=1)
        idx = np.minimum((cdf < 0.5).sum(axis=1), cdf.shape[1] - 1)
        return view.len_sup[np.arange(cdf.shape[0]), idx]


class TRAILPolicy(Policy):
    """SRPT-approx: expected REMAINING output length, re-evaluated at bucket
    boundaries (stand-in for TRAIL's per-iteration MLP repredictions).
    Cost proxy is the output length — TRAIL ignores demand hybridity."""

    name = "trail"
    preemptive = True
    refreshing = True

    def priority(self, sr) -> float:
        lens = sr.length_dist.lengths.astype(np.float64)
        probs = sr.length_dist.probs
        remaining = np.maximum(lens - sr.generated, 1.0)
        alive = lens > sr.generated
        if alive.any():
            # sequential sums so the batched path is bit-identical
            p = probs * alive
            num = np.cumsum(remaining * p)[-1]
            return float(num / np.cumsum(p)[-1])
        return 1.0  # predicted mass exhausted: completion imminent

    def priority_batch(self, view, backend) -> np.ndarray:
        g = np.asarray(view.generated, np.float64)[:, None]
        remaining = np.maximum(view.len_sup - g, 1.0)
        alive = (view.len_sup > g) & (view.len_probs > 0)
        p = np.where(alive, view.len_probs, 0.0)
        den = np.cumsum(p, axis=1)[:, -1]
        num = np.cumsum(remaining * p, axis=1)[:, -1]
        return np.where(den > 0.0, num / np.where(den > 0.0, den, 1.0), 1.0)


class MeanPolicy(Policy):
    """Expected remaining service cost (cost-model aware, no Gittins)."""

    name = "mean"
    preemptive = True
    refreshing = True

    def priority(self, sr) -> float:
        return mean_index(sr.cost_dist, sr.attained_cost)

    def priority_batch(self, view, backend) -> np.ndarray:
        return backend.mean(view.cost_sup, view.cost_probs, view.attained)


class GittinsPolicy(Policy):
    """Gittins index computed once at admission (no runtime refresh)."""

    name = "gittins"
    preemptive = True
    refreshing = False

    def priority(self, sr) -> float:
        return gittins_index(sr.cost_dist, 0.0)

    def priority_batch(self, view, backend) -> np.ndarray:
        return backend.gittins(view.cost_sup, view.cost_probs, None)


class SageSchedPolicy(Policy):
    """The paper's policy: Gittins index over the remaining-cost
    distribution, refreshed at bucket boundaries."""

    name = "sagesched"
    preemptive = True
    refreshing = True

    def priority(self, sr) -> float:
        return gittins_index(sr.cost_dist, sr.attained_cost)

    def priority_batch(self, view, backend) -> np.ndarray:
        return backend.gittins(view.cost_sup, view.cost_probs, view.attained)


class AgedSageSchedPolicy(Policy):
    """BEYOND-PAPER: Gittins with starvation bounding.

    Pure Gittins ordering can starve long requests indefinitely under
    sustained load (unbounded p99 TTLT).  We discount the index by the
    request's queueing age — an aging factor standard in OS schedulers
    but absent from the paper: priority = G / (1 + age/tau).  As tau ->
    inf this is exactly SageSched; small tau approaches FCFS.  Age is
    tracked in *scheduler decisions* via the arrival timestamp, so the
    policy stays stateless.  Evaluated in EXPERIMENTS.md §Beyond.
    """

    name = "sagesched_aged"
    preemptive = True
    refreshing = True
    time_varying = True

    def __init__(self, tau_age: float = 60.0):
        self.tau_age = tau_age
        self.now = 0.0      # injected by Scheduler.set_now()

    def priority(self, sr) -> float:
        g = gittins_index(sr.cost_dist, sr.attained_cost)
        age = max(0.0, self.now - sr.arrival)
        return g / (1.0 + age / self.tau_age)

    def base_priority(self, sr) -> float:
        """Undiscounted Gittins index — cached by BatchState so set_now()
        aging is a pure vectorized discount, no index recomputation."""
        return gittins_index(sr.cost_dist, sr.attained_cost)

    def base_priority_batch(self, view, backend) -> np.ndarray:
        return backend.gittins(view.cost_sup, view.cost_probs, view.attained)

    def apply_age(self, base: np.ndarray, arrival: np.ndarray,
                  now: float) -> np.ndarray:
        age = np.maximum(0.0, now - np.asarray(arrival, np.float64))
        return base / (1.0 + age / self.tau_age)

    def priority_batch(self, view, backend) -> np.ndarray:
        return self.apply_age(self.base_priority_batch(view, backend),
                              view.arrival, self.now)


class HedgedPolicy(Policy):
    """BEYOND-PAPER: online hedging between prediction-trusting and
    prediction-free orderings (robustness to prediction drift).

    Runs two sub-policies side by side — ``trusting`` (default
    SageSched: Gittins over the predicted cost distribution) and
    ``free`` (default FCFS: no per-request information) — and blends
    their *ranks* over the live set:

        priority_i = (w_t * rank_t(i) + w_f * rank_f(i)) / (n - 1)

    Ranks (not raw priorities) make the blend scale-free: Gittins
    indices and arrival timestamps live in incomparable units.  The
    weights follow multiplicative weights / Hedge: at each completion
    the trusting expert is charged ``prediction_loss`` (the realized
    log-loss margin of the admission-time prediction, in [0, 1]) and
    the free expert the constant break-even 0.5, then
    ``w *= exp(-eta * loss)``.  A sharp, correct predictor drives
    w_t -> 1 (pure SageSched); drift drives w_f up and the ordering
    degrades gracefully toward FCFS instead of cliffing on confidently
    wrong indices.  Log-weights are clamped to ``max_log_ratio`` so
    neither expert is ever abandoned — recovery after a regime shift
    takes O(max_log_ratio / eta) completions, not forever.

    Rank blending needs the FULL live set, so the policy sets
    ``rank_based = True``: the Scheduler promotes any dirty row to an
    all-rows refresh and requires an array backend (the object path has
    no batch view to rank over).
    """

    name = "hedged"
    preemptive = True
    rank_based = True   # priorities are ranks over the whole live set

    def __init__(self, trusting: "Policy | str | None" = None,
                 free: "Policy | str | None" = None,
                 eta: float = 0.8,
                 w_trust: float = 0.5,
                 max_log_ratio: float = 6.0,
                 free_loss: float = 0.5,
                 max_len: int = 4096):
        if isinstance(trusting, str):
            trusting = make_policy(trusting)
        if isinstance(free, str):
            free = make_policy(free)
        self.trusting = trusting or SageSchedPolicy()
        self.free = free or FCFSPolicy()
        self.refreshing = self.trusting.refreshing or self.free.refreshing
        self.eta = float(eta)
        self.max_log_ratio = float(max_log_ratio)
        self.free_loss = float(free_loss)
        self.max_len = int(max_len)
        w0 = float(np.clip(w_trust, 1e-6, 1.0 - 1e-6))
        self._lw = np.log(np.array([w0, 1.0 - w0]))
        self._lw -= self._lw.max()
        self.updates = 0

    @property
    def weights(self) -> tuple[float, float]:
        w = np.exp(self._lw - self._lw.max())
        w = w / np.cumsum(w)[-1]
        return float(w[0]), float(w[1])

    def snapshot(self) -> dict:
        w_t, w_f = self.weights
        return {"w_trust": w_t, "w_free": w_f, "updates": self.updates}

    def observe_outcome(self, dist, actual: int) -> None:
        """Hedge update at completion: ``dist`` is the admission-time
        prediction (None when it was a degraded-mode prior — nothing to
        score), ``actual`` the realized output length."""
        if dist is None:
            return
        loss_t = prediction_loss(dist, actual, self.max_len)
        self._lw[0] -= self.eta * loss_t
        self._lw[1] -= self.eta * self.free_loss
        self._lw -= self._lw.max()
        np.clip(self._lw, -self.max_log_ratio, 0.0, out=self._lw)
        self.updates += 1

    def priority(self, sr) -> float:
        raise RuntimeError(
            "hedged priorities are ranks over the whole live set; use an "
            "array priority_backend (numpy/cuda), not 'object'")

    @staticmethod
    def _ranks(prio: np.ndarray, arrival: np.ndarray) -> np.ndarray:
        r = np.empty(prio.shape[0], np.float64)
        r[np.lexsort((arrival, prio))] = np.arange(prio.shape[0],
                                                   dtype=np.float64)
        return r

    def priority_batch(self, view, backend) -> np.ndarray:
        n = view.arrival.shape[0]
        if n == 0:
            return np.zeros(0)
        p_t = np.asarray(self.trusting.priority_batch(view, backend),
                         np.float64)
        p_f = np.asarray(self.free.priority_batch(view, backend), np.float64)
        w_t, w_f = self.weights
        blended = w_t * self._ranks(p_t, view.arrival) \
            + w_f * self._ranks(p_f, view.arrival)
        return blended / max(1, n - 1)

    def next_boundary(self, sr, bucket_size: int) -> float:
        return min(self.trusting.next_boundary(sr, bucket_size),
                   self.free.next_boundary(sr, bucket_size))

    def next_boundary_batch(self, generated, bucket_size: int) -> np.ndarray:
        return np.minimum(
            self.trusting.next_boundary_batch(generated, bucket_size),
            self.free.next_boundary_batch(generated, bucket_size))


_REGISTRY = {
    "fcfs": FCFSPolicy,
    "fastserve": FastServePolicy,
    "ssjf": SSJFPolicy,
    "ltr": LTRPolicy,
    "trail": TRAILPolicy,
    "mean": MeanPolicy,
    "gittins": GittinsPolicy,
    "sagesched": SageSchedPolicy,
    "sagesched_aged": AgedSageSchedPolicy,
    "hedged": HedgedPolicy,
}

POLICY_NAMES = tuple(_REGISTRY)


def make_policy(name: str, **kwargs) -> Policy:
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
