"""Resource-bound-based service-cost modeling (paper Sec. 3.2).

The paper's key observation: whether the backend is *memory-bound* (cost =
cumulative KVCache occupation, ``sum_{l=1}^{I+O} l * U_MT``) or
*compute-bound* (cost = cumulative attention compute,
``sum_{l=I}^{I+O} l * U_CT``), the service cost of a request with input
length I and output length O follows the same paradigm::

    C(I, O) = O^2 / 2 + I * O        (unit constants cancel in rank order)

We implement that model, the two ablation baselines from Sec. 4.3.2
(output-length-only and weighted-overall-length), and the per-architecture
adaptations documented in DESIGN.md Sec. 4 (linear cost for attention-free
SSMs, mixed cost for hybrids, enc-dec cost with one-shot encoder term).

Every model exposes:
  * ``total(I, O)``          — scalar cost of a full request,
  * ``attained(I, o)``       — cost already *consumed* after generating
                                ``o`` of the eventual O tokens (used to
                                refresh the Gittins index at runtime),
  * ``distribution(I, length_dist)`` — pushforward of an output-length
                                distribution through ``total``.

``attained`` is exact: it is the same cumulative sum truncated at ``o``,
so remaining cost = total − attained, consistent with SRPT/Gittins theory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "CostModel",
    "ResourceBoundCost",
    "OutputLengthCost",
    "OverallLengthCost",
    "LinearCost",
    "HybridCost",
    "EncDecCost",
    "CostDistribution",
    "bucketize_support",
    "eviction_scores",
    "make_cost_model",
    "quantile_index",
]


def eviction_scores(ranks: np.ndarray, swap_costs: np.ndarray,
                    memory_weight: float) -> np.ndarray:
    """Capacity-forced-eviction scores — HIGHER means evict FIRST.

    The paper's hybrid true-service-cost says preempting a request is not
    free: its KV must be swapped back in before it can resume, so the
    eviction decision should weigh *service urgency* (the policy's
    priority ranking) against the *memory-restoration cost* (held KV
    bytes ~ predicted swap IO — ``ServiceModel.swap_time`` is affine in
    held bytes, so the two terms merge into one).  Both terms are
    normalized to [0, 1], making the trade-off scale-free across cost
    models whose raw priorities live in arbitrary units:

        score = rank / (n-1)  -  memory_weight * swap / max(swap)

    ``ranks``: position in the policy's order() (0 = most urgent);
    ``swap_costs``: predicted restore cost per candidate (seconds, or
    held tokens/bytes as a proxy); ``memory_weight = 0`` reduces to
    pure reversed priority order (the vLLM baseline).
    """
    ranks = np.asarray(ranks, np.float64)
    n = ranks.shape[0]
    rank_norm = ranks / max(1, n - 1)
    swap = np.asarray(swap_costs, np.float64)
    top = swap.max()
    swap_norm = swap / top if top > 0 else np.zeros_like(swap)
    return rank_norm - float(memory_weight) * swap_norm


def quantile_index(probs: np.ndarray, q: float) -> int:
    """Index of the smallest support point whose CDF reaches ``q``.

    Float rounding can leave cdf[-1] < q (e.g. 0.9999999998 < 1.0), in
    which case searchsorted returns len(cdf) — clip to the last support
    point.  Shared by ``CostDistribution.quantile`` and
    ``LengthDistribution.quantile``.
    """
    cdf = np.cumsum(probs)
    return min(int(np.searchsorted(cdf, q)), probs.shape[0] - 1)


def bucketize_support(support: np.ndarray, probs: np.ndarray, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Pack a ragged discrete distribution into exactly ``k`` points.

    When the distribution has <= k points it is *padded*: the support
    repeats its last (largest) value and the padded probabilities are 0,
    which keeps the support non-decreasing and is exactly inert for every
    batched priority computation (they mask on ``probs > 0``).  When it
    has > k points it is *compressed* by equal-mass binning, with each
    bin represented by its conditional mean — this is the only lossy path
    and is avoided in practice by BatchState's column auto-growth.
    """
    support = np.asarray(support, np.float64)
    probs = np.asarray(probs, np.float64)
    k0 = support.shape[0]
    if k0 == k:
        return support.copy(), probs.copy()
    if k0 < k:
        sup = np.concatenate([support, np.full(k - k0, support[-1])])
        p = np.concatenate([probs, np.zeros(k - k0)])
        return sup, p
    # compress: equal-mass bins, conditional-mean representatives
    cdf = np.cumsum(probs)
    edges = np.searchsorted(cdf, np.linspace(0.0, 1.0, k + 1)[1:-1],
                            side="left")
    bins = np.unique(np.concatenate([[0], edges + 1, [k0]]))
    sup = np.empty(k, np.float64)
    p = np.zeros(k, np.float64)
    for j in range(len(bins) - 1):
        lo, hi = bins[j], bins[j + 1]
        m = probs[lo:hi].sum()
        p[j] = m
        sup[j] = (support[lo:hi] @ probs[lo:hi]) / m if m > 0 \
            else support[lo:hi].mean()
    used = len(bins) - 1
    sup[used:] = sup[used - 1]
    p = p / p.sum()
    return np.maximum.accumulate(sup), p


@dataclass(frozen=True)
class CostDistribution:
    """Discrete cost distribution: support (ascending) + probabilities."""

    support: np.ndarray  # (k,) float64, strictly ascending
    probs: np.ndarray    # (k,) float64, sums to 1

    def __post_init__(self):
        object.__setattr__(self, "support", np.asarray(self.support, np.float64))
        object.__setattr__(self, "probs", np.asarray(self.probs, np.float64))

    @property
    def mean(self) -> float:
        # sequential (cumsum) summation so the batched refresh path —
        # which runs cumsum over zero-padded (n, k) rows — is bit-identical
        # to this scalar oracle
        return float(np.cumsum(self.support * self.probs)[-1])

    def bucketize(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-k (support, probs) arrays for BatchState packing: padded
        (repeat-last support, zero prob) when <= k points, equal-mass
        compressed otherwise.  See ``bucketize_support``."""
        return bucketize_support(self.support, self.probs, k)

    def quantile(self, q: float) -> float:
        """Smallest support point with CDF >= q.  Routing on an upper
        quantile instead of the mean is the robust-placement knob of
        ``CostAwareRouter(route_quantile=...)``."""
        return float(self.support[quantile_index(self.probs, q)])

    def truncate(self, attained: float) -> "CostDistribution | None":
        """Condition on X > ``attained`` WITHOUT re-origining — the
        mid-flight posterior update (repro_torch.core.robust), the absolute-
        support sibling of ``shift``: ``shift`` answers "what remains
        from here" for a Gittins evaluation, ``truncate`` updates the
        stored belief itself so every later consumer (means, quantiles,
        shed scores, further shifts) sees only the unfalsified mass.
        Returns None when everything is falsified (caller substitutes a
        tail belief).  Sequential cumsum renormalizer: bit-identical to
        the batched ``robust.truncate_rows``."""
        alive = self.support > attained
        if not alive.any():
            return None
        p = self.probs[alive]
        return CostDistribution(self.support[alive], p / np.cumsum(p)[-1])

    def shift(self, attained: float) -> "CostDistribution":
        """Condition on X > ``attained`` and re-origin at it (the Bayesian
        update behind the paper's runtime Gittins refresh: mass at costs the
        request has already consumed without finishing is impossible and is
        conditioned out).  If the whole predicted mass is exhausted, the
        remaining cost collapses to "imminent completion"."""
        alive = self.support > attained
        if not alive.any():
            # Prediction exhausted: the request already outran every
            # predicted outcome.  LLM length distributions have decreasing
            # hazard rates (lognormal-like), so the rational belief is a
            # LONG remaining tail, not imminent completion — assume one
            # more max-support's worth of cost (pinning such requests to
            # top priority instead measurably inflates mean TTLT;
            # EXPERIMENTS.md §Perf).
            tail = max(float(self.support[-1]), 1.0)
            return CostDistribution(np.array([tail]), np.array([1.0]))
        rem = self.support[alive] - attained
        probs = self.probs[alive]
        # sequential normalizer (see ``mean``): keeps scalar and batched
        # conditioning bit-identical
        return CostDistribution(rem, probs / np.cumsum(probs)[-1])


class CostModel:
    """Base class; subclasses override ``total`` (vectorized over O)."""

    name = "base"

    def total(self, input_len, output_len):
        raise NotImplementedError

    def attained(self, input_len: int, generated: int) -> float:
        """Cost consumed so far, after ``generated`` output tokens."""
        return float(self.total(input_len, generated))

    def attained_batch(self, input_lens: np.ndarray, generated: np.ndarray
                       ) -> np.ndarray:
        """Vectorized ``attained`` over parallel (n,) arrays.  Subclasses
        override with closed forms; this fallback loops (correct for any
        model, slow — it exists so custom models keep working)."""
        return np.array([self.attained(int(i), int(g))
                         for i, g in zip(np.asarray(input_lens),
                                         np.asarray(generated))], np.float64)

    def distribution(self, input_len: int, lengths: np.ndarray,
                     probs: np.ndarray) -> CostDistribution:
        """Pushforward of an output-length distribution through ``total``.

        ``lengths``/``probs`` describe P(O = lengths[i]) = probs[i].
        """
        costs = np.asarray(self.total(input_len, np.asarray(lengths, np.float64)))
        probs = np.asarray(probs, np.float64)
        if costs.size and np.all(np.diff(costs) > 0):
            # every model here is monotone in O over an ascending support,
            # so the sort/unique/merge below is almost always the identity
            # — skip it (bit-identical: the general path's stable argsort,
            # unique and add.at reduce to copies when costs are strictly
            # ascending)
            return CostDistribution(costs, probs / probs.sum())
        order = np.argsort(costs, kind="stable")
        costs, probs = costs[order], probs[order]
        uniq, inv = np.unique(costs, return_inverse=True)
        merged = np.zeros_like(uniq)
        np.add.at(merged, inv, probs)
        merged = merged / merged.sum()
        return CostDistribution(uniq, merged)

    def distribution_batch(self, input_lens, length_dists
                           ) -> list[CostDistribution]:
        """Batched pushforward: one ``CostDistribution`` per
        (input_len, LengthDistribution) pair.  Supports are ragged, so
        the merge stays per-row; the batched-ingress win is amortizing
        the *prediction* and the BatchState writes around this call.
        Equals the sequence of scalar ``distribution`` calls exactly.
        """
        return [self.distribution(int(il), ld.lengths, ld.probs)
                for il, ld in zip(input_lens, length_dists)]


class ResourceBoundCost(CostModel):
    """The paper's model: C = O^2/2 + I*O (Sec. 3.2)."""

    name = "resource_bound"

    def total(self, input_len, output_len):
        o = np.asarray(output_len, np.float64)
        return o * o / 2.0 + float(input_len) * o

    def attained_batch(self, input_lens, generated):
        i = np.asarray(input_lens, np.float64)
        g = np.asarray(generated, np.float64)
        return g * g / 2.0 + i * g


class OutputLengthCost(CostModel):
    """Ablation: C = O (SSJF / LTR / TRAIL cost proxy)."""

    name = "output_length"

    def total(self, input_len, output_len):
        return np.asarray(output_len, np.float64)

    def attained_batch(self, input_lens, generated):
        return np.asarray(generated, np.float64).copy()


class OverallLengthCost(CostModel):
    """Ablation: C = I + 2*O (VTC-style weighted token count,
    Sheng et al. 2024; the paper doubles the output weight)."""

    name = "overall_length"

    def total(self, input_len, output_len):
        return float(input_len) + 2.0 * np.asarray(output_len, np.float64)

    def attained_batch(self, input_lens, generated):
        return np.asarray(input_lens, np.float64) \
            + 2.0 * np.asarray(generated, np.float64)


class LinearCost(CostModel):
    """SSM adaptation: constant state, constant per-step cost →
    C = (I + O) (DESIGN.md Sec. 4, mamba2)."""

    name = "linear"

    def total(self, input_len, output_len):
        return float(input_len) + np.asarray(output_len, np.float64)

    def attained_batch(self, input_lens, generated):
        return np.asarray(input_lens, np.float64) \
            + np.asarray(generated, np.float64)


class HybridCost(CostModel):
    """Hybrid (Zamba2): alpha * quadratic attention term from the shared
    attention blocks + beta * linear SSM term."""

    name = "hybrid"

    def __init__(self, attn_fraction: float = 0.15, ssm_fraction: float = 0.85,
                 ssm_step_weight: float = 64.0):
        # ssm_step_weight converts "one SSM step" into KV-token-step units so
        # the two terms are commensurable (d_state-sized recurrent state).
        self.alpha = attn_fraction
        self.beta = ssm_fraction * ssm_step_weight

    def total(self, input_len, output_len):
        o = np.asarray(output_len, np.float64)
        quad = o * o / 2.0 + float(input_len) * o
        lin = float(input_len) + o
        return self.alpha * quad + self.beta * lin

    def attained_batch(self, input_lens, generated):
        i = np.asarray(input_lens, np.float64)
        g = np.asarray(generated, np.float64)
        return self.alpha * (g * g / 2.0 + i * g) + self.beta * (i + g)


class EncDecCost(CostModel):
    """Encoder-decoder (Seamless backbone): one-shot encoder cost ~ I^2
    (prefill-like), decoder self-attention quadratic in O, cross-attention
    linear in I per decoded token."""

    name = "enc_dec"

    def __init__(self, encoder_weight: float = 0.5):
        self.encoder_weight = encoder_weight

    def total(self, input_len, output_len):
        o = np.asarray(output_len, np.float64)
        i = float(input_len)
        return o * o / 2.0 + i * o + self.encoder_weight * i * i

    def attained(self, input_len: int, generated: int) -> float:
        # encoder cost is paid up-front at prefill
        i = float(input_len)
        g = float(generated)
        return g * g / 2.0 + i * g + self.encoder_weight * i * i

    def attained_batch(self, input_lens, generated):
        i = np.asarray(input_lens, np.float64)
        g = np.asarray(generated, np.float64)
        return g * g / 2.0 + i * g + self.encoder_weight * i * i


_REGISTRY = {
    "resource_bound": ResourceBoundCost,
    "output_length": OutputLengthCost,
    "overall_length": OverallLengthCost,
    "linear": LinearCost,
    "hybrid": HybridCost,
    "enc_dec": EncDecCost,
}


def make_cost_model(name: str, **kwargs) -> CostModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown cost model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
