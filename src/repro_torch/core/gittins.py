"""Gittins index for discrete cost distributions (paper Sec. 3.3).

For a request with (remaining-)cost distribution D, the Gittins index is

    G(D) = inf_{Delta > 0}  E[min(X, Delta)] / P(X <= Delta),   X ~ D.

Smaller G = higher priority.  For M/G/1-style mean-latency scheduling with
known duration distributions, serving the smallest Gittins index is optimal
(Gittins & Jones 1979; Gittins 1989) — this is the paper's queuing policy.

For a *discrete* distribution with support c_1 < ... < c_k the infimum is
attained at some Delta = c_j (the objective is piecewise-linear in Delta
between support points, increasing in Delta past the last mass that the
budget can reach), so the index reduces to a min over k candidate ratios:

    G = min_j  [ sum_{i<=j} c_i p_i + c_j * (1 - sum_{i<=j} p_i) ]
               / sum_{i<=j} p_i

computable with two prefix sums — O(k).  ``gittins_index_batch`` evaluates
a batch of bucketized distributions at once (the form the CUDA kernel in
``repro_torch.kernels.gittins`` accelerates for large cluster schedulers).

Runtime refresh (paper): after a request has consumed ``attained`` cost,
its remaining-cost distribution is D conditioned on X > attained and
shifted; the paper refreshes only at cost-bucket boundaries to bound
overhead and avoid priority thrashing.  That bucketization lives in
``repro_torch.core.scheduler``; here we expose the pure math.
"""

from __future__ import annotations

import numpy as np

from .cost_model import CostDistribution

__all__ = ["gittins_index", "gittins_index_batch", "mean_index",
           "mean_index_batch"]


def gittins_index(dist: CostDistribution, attained: float = 0.0) -> float:
    """Gittins index of the remaining cost after ``attained`` service."""
    d = dist.shift(attained) if attained > 0.0 else dist
    c = d.support
    p = d.probs
    mass = np.cumsum(p)                       # P(X <= c_j)
    spent = np.cumsum(c * p)                  # E[X ; X <= c_j]
    num = spent + c * (1.0 - mass)            # E[min(X, c_j)]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(mass > 0.0, num / mass, np.inf)
    return float(ratio.min())


def _tail_belief(support: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Per-row tail belief for exhausted predictions: the largest real
    support value (clamped to >= 1), matching ``CostDistribution.shift``."""
    return np.maximum(
        np.max(np.where(probs > 0.0, support, -np.inf), axis=1), 1.0)


def _condition_batch(support: np.ndarray, probs: np.ndarray,
                     attained: np.ndarray | None):
    """Batched form of ``CostDistribution.shift``: condition each row on
    X > attained[i] and re-origin, entirely with masks (no ragged
    filtering).  Zeroed-out entries contribute exact 0.0 to every cumsum,
    so results at live positions are bit-identical to the scalar path.

    Returns (c, p, alive, exhausted): remaining-cost support, conditioned
    probabilities, live mask, and a mask of rows whose predicted mass is
    fully consumed (None when no row is — the common case, so the tail
    belief is only materialized when needed).
    """
    valid = probs > 0.0                      # padded entries carry prob 0
    if attained is None:
        return support, probs, valid, None
    att = np.maximum(np.asarray(attained, np.float64), 0.0)
    cond = att > 0.0                         # rows that actually shift
    all_cond = bool(cond.all())
    if all_cond:
        alive = valid & (support > att[:, None])
    else:
        alive = valid & (~cond[:, None] | (support > att[:, None]))
    p = np.where(alive, probs, 0.0)
    psum = np.cumsum(p, axis=1)[:, -1]       # sequential, matches .shift()
    exhausted = cond & (psum <= 0.0)
    safe = np.where(psum > 0.0, psum, 1.0)
    if all_cond:
        p /= safe[:, None]                   # p is a fresh temp: in-place
    else:
        p = np.where(cond[:, None], p / safe[:, None], p)
    c = np.where(alive, support - att[:, None], 0.0)
    return c, p, alive, exhausted if exhausted.any() else None


def gittins_index_batch(support: np.ndarray, probs: np.ndarray,
                        attained: np.ndarray | None = None) -> np.ndarray:
    """Vectorized Gittins indices for a batch of distributions.

    support: (n, k) cost support, non-decreasing along axis 1 (for ragged
        batches pad with prob 0; any finite pad support value works —
        padded columns are masked out).
    probs:   (n, k) probabilities (each row sums to 1; padded entries 0).
    attained: optional (n,) cost already consumed per row; each row is
        conditioned on X > attained and re-origined exactly like
        ``CostDistribution.shift`` (including the exhausted-prediction
        tail belief), making this the one-call batched equivalent of
        ``gittins_index(dist_i, attained_i)`` for every i.
    Returns (n,) indices.  This is the numpy oracle for the CUDA Gittins kernel.
    """
    support = np.asarray(support, np.float64)
    probs = np.asarray(probs, np.float64)
    c, p, alive, exhausted = _condition_batch(support, probs, attained)
    # pre-zero dead columns: no inf * 0.  The conditioned path already
    # returns c zeroed at dead columns, so only the raw path pays a copy.
    cz = c if attained is not None else np.where(alive, c, 0.0)
    mass = np.cumsum(p, axis=1)
    spent = np.cumsum(cz * p, axis=1)
    num = spent + cz * (1.0 - mass)
    # at every alive column mass >= its own (positive) prob, so ``alive``
    # alone gates the division safely
    ratio = np.where(alive, num / np.where(alive, mass, 1.0), np.inf)
    out = ratio.min(axis=1)
    if exhausted is not None:
        out = np.where(exhausted, _tail_belief(support, probs), out)
    return out


def mean_index(dist: CostDistribution, attained: float = 0.0) -> float:
    """Ablation (paper Fig. 6 / Fig. 11 'Mean'): expected remaining cost."""
    d = dist.shift(attained) if attained > 0.0 else dist
    return d.mean


def mean_index_batch(support: np.ndarray, probs: np.ndarray,
                     attained: np.ndarray | None = None) -> np.ndarray:
    """Batched ``mean_index``: expected remaining cost per row, with the
    same conditioning/tail semantics as ``gittins_index_batch``."""
    support = np.asarray(support, np.float64)
    probs = np.asarray(probs, np.float64)
    c, p, alive, exhausted = _condition_batch(support, probs, attained)
    cz = c if attained is not None else np.where(alive, c, 0.0)
    mean = np.cumsum(cz * p, axis=1)[:, -1]
    if exhausted is not None:
        mean = np.where(exhausted, _tail_belief(support, probs), mean)
    return mean
