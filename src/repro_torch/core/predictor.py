"""Output-length distribution predictors (paper Sec. 3.1 + ablations 4.3.1).

The paper's predictor is *semantic-aware* and *history-based*: embed the
incoming prompt, retrieve recently-served requests whose prompt embedding
has cosine similarity >= tau (default 0.8), and return the empirical
distribution of THEIR output lengths as the prediction.  Training-free,
model-agnostic, <0.5 ms per request.

Ablation baselines (Sec. 4.3.1):
  * ``LengthHistoryPredictor`` — semantic-UNAWARE history-based: retrieves
    by input-length proximity instead of prompt content.
  * ``ProxyModelPredictor`` — semantic-aware LLM-based: a fitted parametric
    head over the prompt embedding (stand-in for the DistillBERT model of
    SSJF with its argmax layer removed so it emits a distribution).  This
    carries training cost and emulation error, which is the paper's point.
  * ``OraclePredictor`` — knows the true per-request distribution; used to
    isolate scheduling-policy effects in tests/benchmarks.
  * ``PointPredictor`` — wraps any predictor, collapsing the distribution
    onto its mean (what SSJF/LTR effectively schedule with).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cost_model import quantile_index
from .embedding import PromptEmbedder
from .history import HistoryStore

__all__ = [
    "LengthDistribution",
    "Predictor",
    "SemanticHistoryPredictor",
    "LengthHistoryPredictor",
    "ProxyModelPredictor",
    "OraclePredictor",
    "PointPredictor",
    "empirical_distribution",
]


@dataclass(frozen=True)
class LengthDistribution:
    """Discrete distribution over output token lengths."""

    lengths: np.ndarray  # (k,) int64, strictly ascending
    probs: np.ndarray    # (k,) float64, sums to 1

    def __post_init__(self):
        object.__setattr__(self, "lengths", np.asarray(self.lengths, np.int64))
        object.__setattr__(self, "probs", np.asarray(self.probs, np.float64))

    @property
    def mean(self) -> float:
        # sequential (cumsum) summation: keeps SSJF's batched priority
        # path bit-identical to this scalar oracle (numpy's pairwise
        # np.sum trees differ between compact and zero-padded arrays)
        return float(np.cumsum(self.lengths * self.probs)[-1])

    def quantile(self, q: float) -> int:
        return int(self.lengths[quantile_index(self.probs, q)])

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.choice(self.lengths, p=self.probs))

    def truncate(self, min_exclusive: int) -> "LengthDistribution | None":
        """Condition on L > ``min_exclusive`` keeping lengths absolute —
        the mid-flight posterior update (repro_torch.core.robust): a request
        that decoded past a predicted quantile has falsified the mass at
        or below it.  Unlike ``CostDistribution.shift`` there is no
        re-origin (the scheduler's generated/attained bookkeeping is
        absolute).  Returns None when the whole predicted mass is
        falsified (caller must substitute a tail belief).  Sequential
        cumsum renormalizer: bit-identical to the batched
        ``robust.truncate_rows`` over zero-padded rows."""
        alive = self.lengths > int(min_exclusive)
        if not alive.any():
            return None
        p = self.probs[alive]
        return LengthDistribution(self.lengths[alive], p / np.cumsum(p)[-1])

    def mix_uniform(self, weight: float, max_len: int, k: int = 32
                    ) -> "LengthDistribution":
        """Blend with a uniform distribution (paper Fig. 11 noise test:
        'merging a uniform distribution ... following a weight ratio 1:4'
        → weight = 0.2)."""
        grid = np.unique(np.linspace(1, max_len, k).astype(np.int64))
        lengths = np.union1d(self.lengths, grid)
        probs = np.zeros(lengths.shape[0], np.float64)
        probs[np.searchsorted(lengths, self.lengths)] += (1 - weight) * self.probs
        probs[np.searchsorted(lengths, grid)] += weight / grid.size
        return LengthDistribution(lengths, probs / probs.sum())


def empirical_distribution(samples: np.ndarray, max_support: int = 64
                           ) -> LengthDistribution:
    """Empirical distribution of observed lengths, optionally compressed to
    <= max_support points by quantile binning (keeps Gittins cheap)."""
    samples = np.asarray(samples, np.int64)
    if samples.size == 0:
        raise ValueError("cannot build a distribution from zero samples")
    uniq, counts = np.unique(samples, return_counts=True)
    if uniq.size > max_support:
        # quantile-bin to max_support representative points
        qs = np.linspace(0, 1, max_support)
        edges = np.quantile(samples, qs, method="nearest").astype(np.int64)
        edges = np.unique(edges)
        idx = np.clip(np.searchsorted(edges, samples, side="right") - 1,
                      0, edges.size - 1)
        probs = np.bincount(idx, minlength=edges.size).astype(np.float64)
        keep = probs > 0
        return LengthDistribution(edges[keep], probs[keep] / probs.sum())
    return LengthDistribution(uniq, counts.astype(np.float64) / counts.sum())


class Predictor:
    """Interface: predict output-length distributions for prompts.

    The primitive is the *batched* call (``predict_batch``): arrivals at
    high rate come in bursts, and the built-in predictors amortize their
    expensive step (the semantic-history search, the proxy-model head)
    across the burst.  Scalar ``predict`` is sugar — the built-ins define
    it as the B = 1 case.  Custom predictors may do the opposite and only
    override ``predict``; the base ``predict_batch`` then loops it.
    Either way the two surfaces return identical distributions for
    identical history state (asserted bit-identically in
    tests/test_batch_ingress.py).
    """

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        raise NotImplementedError

    def predict_batch(self, prompts: list[str], input_lens
                      ) -> list[LengthDistribution]:
        """Batched prediction for a burst of arrivals; default loops the
        scalar ``predict`` so custom predictors keep working."""
        return [self.predict(p, int(il))
                for p, il in zip(prompts, input_lens)]

    @property
    def has_batch(self) -> bool:
        """True when ``predict_batch`` is trustworthy: it must be defined
        at (or below) the class that defines the scalar ``predict`` in
        the MRO (the same rule as ``Policy.has_batch``).  A subclass of a
        built-in predictor that overrides only ``predict`` would
        otherwise have its override silently bypassed by the inherited
        batch path; batched callers consult this flag and fall back to
        looping the scalar ``predict``."""
        cls = type(self)
        pb = next(c for c in cls.__mro__ if "predict_batch" in c.__dict__)
        pr = next((c for c in cls.__mro__ if "predict" in c.__dict__),
                  Predictor)
        return issubclass(pb, pr)

    def predict_many(self, prompts: list[str], input_lens
                     ) -> list[LengthDistribution]:
        """Burst dispatch for batched callers: the vectorized
        ``predict_batch`` when it is authoritative (``has_batch``), else
        a loop over the scalar ``predict`` so overrides are honored."""
        if self.has_batch:
            return self.predict_batch(prompts, input_lens)
        return [self.predict(p, int(il))
                for p, il in zip(prompts, input_lens)]

    def observe(self, prompt: str, input_len: int, output_len: int) -> None:
        """Feed back a completed request (history-based predictors learn)."""


class SemanticHistoryPredictor(Predictor):
    """The paper's predictor (Sec. 3.1).

    similarity_threshold: cosine threshold tau (default 0.8, Fig. 13a).
    min_matches: below this, progressively relax tau, then fall back to the
        global recent-window marginal (footnote 3's public-dataset
        augmentation is served by ``seed``).
    """

    def __init__(self, embedder: PromptEmbedder | None = None,
                 history: HistoryStore | None = None,
                 similarity_threshold: float = 0.8,
                 min_matches: int = 8,
                 max_support: int = 64,
                 default_length: int = 256):
        self.embedder = embedder or PromptEmbedder()
        self.history = history or HistoryStore(self.embedder.dim)
        self.similarity_threshold = similarity_threshold
        self.min_matches = min_matches
        self.max_support = max_support
        self.default_length = default_length
        self._embed_cache: dict[str, np.ndarray] = {}

    # -- embedding with a tiny memo so observe() reuses predict()'s work
    def _embed(self, prompt: str) -> np.ndarray:
        e = self._embed_cache.get(prompt)
        if e is None:
            e = self.embedder.embed(prompt)
            if len(self._embed_cache) > 4096:
                self._embed_cache.clear()
            self._embed_cache[prompt] = e
        return e

    def seed(self, prompts: list[str], input_lens, output_lens) -> None:
        """Warm-up augmentation with public-dataset records (footnote 3)."""
        embs = self.embedder.embed_batch(prompts)
        self.history.add_batch(embs, input_lens, output_lens)

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        return self.predict_batch([prompt], [input_len])[0]

    def predict_batch(self, prompts: list[str], input_lens
                      ) -> list[LengthDistribution]:
        """The batch-first retrieval path: ONE (B, H) cosine matmul over
        the unique prompts of the burst, per-row threshold relaxation on
        the cached similarities, and a shared global-marginal fallback.

        A burst frequently repeats semantically identical prompts (that
        clustering is the predictor's whole premise, Fig. 4), so the
        search runs once per *unique* prompt — the history is fixed for
        the duration of the call, which also makes this bit-identical to
        B scalar ``predict`` calls.
        """
        n = len(prompts)
        if n == 0:
            return []
        uniq: dict[str, int] = {}
        rows = np.empty(n, np.int64)
        order: list[str] = []
        for j, p in enumerate(prompts):
            r = uniq.get(p)
            if r is None:
                r = uniq[p] = len(order)
                order.append(p)
            rows[j] = r
        embs = np.stack([self._embed(p) for p in order])
        hist = self.history
        sims = hist.similarity_batch(embs)
        glob_dist = None
        preds: list[LengthDistribution] = []
        for r in range(len(order)):
            tau = self.similarity_threshold
            idx = hist.threshold_matches(sims[r], embs[r], tau)
            while idx.size < self.min_matches and tau > 0.3:
                tau -= 0.1  # progressive relaxation on the cached sims
                idx = hist.threshold_matches(sims[r], embs[r], tau)
            if idx.size >= 1:
                preds.append(empirical_distribution(
                    hist.output_lengths(idx), self.max_support))
                continue
            if glob_dist is None:  # footnote-3 fallback, computed once
                glob = hist.global_output_lengths()
                glob_dist = empirical_distribution(glob, self.max_support) \
                    if glob.size > 0 else LengthDistribution(
                        np.array([self.default_length]), np.array([1.0]))
            preds.append(glob_dist)
        return [preds[r] for r in rows]

    def observe(self, prompt: str, input_len: int, output_len: int) -> None:
        self.history.add(self._embed(prompt), input_len, output_len)


class LengthHistoryPredictor(Predictor):
    """Semantic-UNAWARE ablation: retrieve history by input-length proximity
    (paper Sec. 4.3.1 baseline 1)."""

    def __init__(self, history: HistoryStore | None = None,
                 rel_tol: float = 0.2, max_support: int = 64,
                 default_length: int = 256):
        self.history = history or HistoryStore(dim=1)
        self.rel_tol = rel_tol
        self.max_support = max_support
        self.default_length = default_length
        self._zero = np.zeros(self.history.dim, np.float32)

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        return self.predict_batch([prompt], [input_len])[0]

    def predict_batch(self, prompts: list[str], input_lens
                      ) -> list[LengthDistribution]:
        if len(prompts) == 0:
            return []
        matches = self.history.search_by_input_len_batch(input_lens,
                                                         self.rel_tol)
        default = None
        out = []
        for idx in matches:
            if idx.size >= 1:
                out.append(empirical_distribution(
                    self.history.output_lengths(idx), self.max_support))
            else:
                if default is None:
                    default = LengthDistribution(
                        np.array([self.default_length]), np.array([1.0]))
                out.append(default)
        return out

    def observe(self, prompt: str, input_len: int, output_len: int) -> None:
        self.history.add(self._zero, input_len, output_len)


class ProxyModelPredictor(Predictor):
    """Semantic-aware LLM-based ablation (paper Sec. 4.3.1 baseline 2).

    Stand-in for a fine-tuned DistillBERT with the argmax layer removed:
    a ridge-regression bucket-logit head over the hashed prompt embedding,
    refit periodically from accumulated (embedding, output_len) pairs.
    This emulates the *class* of model-based distribution predictors: it
    carries fit cost and pays emulation error for rare prompts.
    """

    def __init__(self, embedder: PromptEmbedder | None = None,
                 n_buckets: int = 20, bucket_width: int = 100,
                 refit_every: int = 512, l2: float = 1.0,
                 default_length: int = 256):
        self.embedder = embedder or PromptEmbedder()
        self.n_buckets = n_buckets
        self.bucket_width = bucket_width
        self.refit_every = refit_every
        self.l2 = l2
        self.default_length = default_length
        self._X: list[np.ndarray] = []
        self._y: list[int] = []
        self._W: np.ndarray | None = None  # (dim, n_buckets)
        self._since_fit = 0

    def _bucket(self, output_len: int) -> int:
        return min(self.n_buckets - 1, output_len // self.bucket_width)

    def _fit(self) -> None:
        X = np.stack(self._X)                       # (n, dim)
        Y = np.zeros((X.shape[0], self.n_buckets))  # one-hot targets
        Y[np.arange(X.shape[0]), [self._bucket(y) for y in self._y]] = 1.0
        A = X.T @ X + self.l2 * np.eye(X.shape[1])
        self._W = np.linalg.solve(A, X.T @ Y)
        self._since_fit = 0

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        return self.predict_batch([prompt], [input_len])[0]

    def predict_batch(self, prompts: list[str], input_lens
                      ) -> list[LengthDistribution]:
        n = len(prompts)
        if n == 0:
            return []
        if self._W is None:
            d = LengthDistribution(np.array([self.default_length]),
                                   np.array([1.0]))
            return [d] * n
        embs = np.stack([self.embedder.embed(p) for p in prompts])
        # non-optimized einsum fixes the d-reduction order per output
        # element regardless of B — the batch/scalar parity requirement a
        # BLAS gemv/gemm pair cannot meet (their blocking differs by shape)
        logits = np.einsum("bd,dk->bk", embs, self._W)
        centers = (np.arange(self.n_buckets) + 0.5) * self.bucket_width
        out = []
        for b in range(n):
            lg = logits[b] - logits[b].max()
            probs = np.exp(lg * 4.0)  # sharpen: ridge scores are soft
            probs = probs / probs.sum()
            keep = probs > 1e-4
            out.append(LengthDistribution(centers[keep].astype(np.int64),
                                          probs[keep] / probs[keep].sum()))
        return out

    def observe(self, prompt: str, input_len: int, output_len: int) -> None:
        self._X.append(self.embedder.embed(prompt))
        self._y.append(output_len)
        if len(self._X) > 20_000:  # bound memory
            self._X = self._X[-10_000:]
            self._y = self._y[-10_000:]
        self._since_fit += 1
        if self._since_fit >= self.refit_every and len(self._X) >= 64:
            self._fit()


class OraclePredictor(Predictor):
    """Knows the true distribution per request (injected by the workload);
    used to isolate the scheduling policy from prediction error."""

    def __init__(self):
        self._truth: dict[str, LengthDistribution] = {}

    def register(self, prompt: str, dist: LengthDistribution) -> None:
        self._truth[prompt] = dist

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        return self.predict_batch([prompt], [input_len])[0]

    def predict_batch(self, prompts: list[str], input_lens
                      ) -> list[LengthDistribution]:
        """Batched truth-table lookups (O(1) per prompt — nothing to
        amortize; the override keeps the batch surface uniform)."""
        missing = [p for p in prompts if p not in self._truth]
        if missing:
            raise KeyError("oracle has no registered distribution for prompt")
        return [self._truth[p] for p in prompts]


class PointPredictor(Predictor):
    """Collapse any predictor's distribution onto its mean — what
    point-estimate schedulers (SSJF/LTR) consume."""

    def __init__(self, inner: Predictor):
        self.inner = inner

    def predict(self, prompt: str, input_len: int) -> LengthDistribution:
        return self.predict_batch([prompt], [input_len])[0]

    def predict_batch(self, prompts: list[str], input_lens
                      ) -> list[LengthDistribution]:
        """Collapse through the inner predictor's *batch* path (scalar
        fallback if its batch path is not authoritative), so a burst
        pays the inner search once."""
        return [LengthDistribution(np.array([max(1, round(d.mean))]),
                                   np.array([1.0]))
                for d in self.inner.predict_many(prompts, input_lens)]

    def observe(self, prompt: str, input_len: int, output_len: int) -> None:
        self.inner.observe(prompt, input_len, output_len)
