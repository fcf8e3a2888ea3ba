"""Adaptive robustness under prediction drift (beyond-paper subsystem).

SageSched's edge comes from trusting a predicted output-length
distribution, and every predictor in this repo freezes that prediction
at admission.  A drifting workload (new tenant, changed dataset, stale
history window) therefore rots the Gittins ranking silently: the
scheduler keeps acting on beliefs the requests themselves are busy
falsifying.  The scheduler's degraded mode only fires when the predictor
*throws*; this module is the defense for when it *lies*.  Three
mechanisms, designed to compose (Adaptively Robust LLM Inference
Optimization, arXiv:2508.14544, is the hedging playbook):

  * **Mid-flight posteriors** — ``truncate_rows``: one vectorized
    truncate-and-renormalize over the (n, k) bucketized supports in
    ``BatchState``, applied when a request decodes past a predicted
    quantile.  It is the batched sibling of ``CostDistribution.shift``
    minus the re-origin: supports stay absolute (the scheduler's
    ``attained`` bookkeeping is absolute), dead mass is zeroed, and the
    renormalizer is a sequential cumsum so the scalar
    ``LengthDistribution.truncate`` / ``CostDistribution.truncate``
    oracles match bit for bit.

  * **Realized prediction error** — ``prediction_loss``: the log-loss
    margin of the predicted distribution against the prediction-free
    flat prior, evaluated at completion and squashed to [0, 1].  0.5 is
    the break-even point ("no better than no prediction"); the hedging
    controller (``policies.HedgedPolicy``) feeds this into
    multiplicative weights.

  * **Calibration monitoring** — ``CalibrationMonitor``: rolling
    per-tenant coverage@q, observed/predicted length ratio, and CRPS,
    fed by the scheduler's completion path.  Its ``widen_weight`` maps a
    coverage deficit to a conformal widening weight that the scheduler
    applies through ``LengthDistribution.mix_uniform`` at admission —
    quantile-level use of the distribution responds to miscalibration
    (arXiv:2604.00499) instead of cliffing.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["truncate_rows", "prediction_loss", "crps",
           "CalibrationMonitor"]


def truncate_rows(support: np.ndarray, probs: np.ndarray,
                  cut: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Condition (n, k) bucketized distribution rows on X > cut[i].

    One vectorized pass: mass at support points <= the row's cut is
    zeroed and the survivors are renormalized IN PLACE of the original
    column positions — supports are untouched (they stay absolute), so
    leading dead columns simply carry prob 0, a shape every batched
    consumer already treats as inert (the Gittins kernels, TRAIL/LTR
    and the SSJF mean all mask on ``probs > 0`` / accumulate exact
    zeros).  The renormalizer is a sequential ``cumsum`` so the result
    is bit-identical to the compact scalar ``truncate`` oracles on
    ``LengthDistribution`` / ``CostDistribution``.

    Returns ``(new_probs, exhausted)``: rows whose whole predicted mass
    sits at or below the cut (the request outran its prediction) come
    back untouched with ``exhausted[i] = True`` — the caller must
    replace them with a proper tail belief (the scheduler rebuilds a
    flat ``mix_uniform`` fallback; never a NaN / zero-mass row).
    """
    support = np.asarray(support, np.float64)
    probs = np.asarray(probs, np.float64)
    cut = np.asarray(cut, np.float64)
    alive = (support > cut[:, None]) & (probs > 0.0)
    p = np.where(alive, probs, 0.0)
    norm = np.cumsum(p, axis=1)[:, -1]
    exhausted = norm <= 0.0
    out = p / np.where(exhausted, 1.0, norm)[:, None]
    out[exhausted] = probs[exhausted]
    return out, exhausted


def prediction_loss(dist, actual: int, max_len: int, *,
                    window: float = 0.25, scale: float = 8.0) -> float:
    """Realized error of a predicted length distribution, in [0, 1].

    Scores the log-loss of the predicted mass in a +/- ``window``
    relative band around the realized length against the same band's
    mass under a flat prior over [1, max_len] — the prediction-free
    belief the degraded mode schedules with.  The margin is squashed so

        0.0  = sharp and right (mass concentrated on the outcome),
        0.5  = exactly as informative as no prediction,
        1.0  = confidently wrong (negligible mass near the outcome).

    ``HedgedPolicy`` charges its prediction-free expert the constant
    0.5, so the hedge weights race on exactly this margin.
    """
    actual = int(actual)
    half = max(4.0, window * actual)
    lengths = np.asarray(dist.lengths, np.float64)
    in_win = (lengths >= actual - half) & (lengths <= actual + half)
    p_pred = float(np.cumsum(np.where(in_win, dist.probs, 0.0))[-1]) \
        if lengths.size else 0.0
    p_flat = min(1.0, (2.0 * half + 1.0) / max(2, max_len))
    margin = -np.log(max(p_pred, 1e-9)) + np.log(max(p_flat, 1e-9))
    return float(np.clip(0.5 + margin / (2.0 * scale), 0.0, 1.0))


def crps(lengths: np.ndarray, probs: np.ndarray, actual: float) -> float:
    """Continuous ranked probability score of a discrete distribution
    against one observation, in token units (0 = point mass on the
    truth; grows with both bias and spread).  Computed as the exact
    integral of (F(x) - H(x - actual))^2 between the outermost
    breakpoints of the step functions."""
    lengths = np.asarray(lengths, np.float64)
    y = float(actual)
    xs = np.unique(np.append(lengths, y))
    if xs.size < 2:
        return 0.0
    cdf = np.cumsum(np.asarray(probs, np.float64))
    pos = np.searchsorted(lengths, xs, side="right")
    f = np.where(pos > 0, cdf[np.minimum(pos, cdf.size) - 1], 0.0)
    h = (xs >= y).astype(np.float64)
    return float(np.cumsum((f[:-1] - h[:-1]) ** 2 * np.diff(xs))[-1])


class _TenantWindow:
    """Rolling window of completion-time calibration samples with O(1)
    running aggregates (observe is on the scheduler's completion path)."""

    def __init__(self, cap: int, n_q: int):
        self.cap = cap
        self.buf: deque = deque()
        self.cov_sum = np.zeros(n_q)
        self.actual_sum = 0.0
        self.pred_sum = 0.0
        self.crps_sum = 0.0

    def push(self, covered: np.ndarray, actual: float, pred_mean: float,
             score: float) -> None:
        self.buf.append((covered, actual, pred_mean, score))
        self.cov_sum += covered
        self.actual_sum += actual
        self.pred_sum += pred_mean
        self.crps_sum += score
        if len(self.buf) > self.cap:
            c, a, p, s = self.buf.popleft()
            self.cov_sum -= c
            self.actual_sum -= a
            self.pred_sum -= p
            self.crps_sum -= s

    @property
    def count(self) -> int:
        return len(self.buf)


class CalibrationMonitor:
    """Rolling per-tenant calibration statistics over completed requests.

    ``observe(tenant, dist, actual)`` records, per completion, whether
    the realized length was covered at each tracked quantile, the
    predicted mean, and the CRPS — all against the *admission-time*
    prediction (never the mid-flight posterior, which trivially covers).
    ``summary()`` exports the per-tenant table surfaced in
    ``Scheduler.stats`` / ``EngineMetrics`` / ``Gateway.summary``;
    ``widen_weight`` converts a coverage deficit at the highest tracked
    quantile into the conformal ``mix_uniform`` weight the scheduler
    applies to that tenant's next admissions.
    """

    def __init__(self, window: int = 256,
                 quantiles: tuple[float, ...] = (0.5, 0.9),
                 min_samples: int = 16,
                 widen_gain: float = 2.0,
                 max_widen: float = 0.5):
        self.window = int(window)
        self.quantiles = tuple(float(q) for q in quantiles)
        self.min_samples = int(min_samples)
        self.widen_gain = float(widen_gain)
        self.max_widen = float(max_widen)
        self._tenants: dict[str, _TenantWindow] = {}

    def observe(self, tenant: str, dist, actual: int) -> None:
        w = self._tenants.get(tenant)
        if w is None:
            w = self._tenants[tenant] = _TenantWindow(self.window,
                                                      len(self.quantiles))
        actual = int(actual)
        covered = np.array([actual <= dist.quantile(q)
                            for q in self.quantiles], np.float64)
        w.push(covered, float(actual), float(dist.mean),
               crps(dist.lengths, dist.probs, actual))

    def summary(self) -> dict:
        out = {}
        for tenant, w in sorted(self._tenants.items()):
            n = w.count
            if n == 0:
                continue
            stats = {"count": n,
                     "observed_over_predicted":
                         float(w.actual_sum / max(w.pred_sum, 1e-9)),
                     "crps_tokens": float(w.crps_sum / n)}
            for j, q in enumerate(self.quantiles):
                stats[f"coverage@{q:g}"] = float(w.cov_sum[j] / n)
            out[tenant] = stats
        return out

    def widen_weight(self, tenant: str) -> float:
        """Conformal widening weight for a tenant's next admissions:
        0 until ``min_samples`` completions exist, then proportional to
        the coverage deficit at the highest tracked quantile (a well-
        calibrated or over-covered tenant widens by exactly 0)."""
        w = self._tenants.get(tenant)
        if w is None or w.count < self.min_samples:
            return 0.0
        j = int(np.argmax(self.quantiles))
        q_hi = self.quantiles[j]
        deficit = q_hi - w.cov_sum[j] / w.count
        if deficit <= 0.0:
            return 0.0
        return float(min(self.max_widen, self.widen_gain * deficit))
