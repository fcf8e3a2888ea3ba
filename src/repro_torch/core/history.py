"""FIFO history store with exact (flat) cosine-similarity search.

Paper Sec. 3.1: "Our history window has a size of 10,000 records and keeps
updating in a FIFO manner. ... We use the efficient FAISS IndexFlat tool to
perform embedding search."  FAISS IndexFlat is an exact brute-force search;
we reproduce the identical algorithm as a single matmul over a pre-allocated
ring buffer — no external dependency, same results, and comparable speed at
the 10k scale (<<1 ms).

The search surface is *batch-first* (batched ingress): a burst of B
queries is one ``(B, H)`` cosine matmul (``search_similar_batch``), and the
scalar ``search_similar`` is its B = 1 case.  Because BLAS may reorder the
reduction differently per batch shape, thresholding goes through a
deterministic exact-recheck band (``threshold_matches``) so the match set —
and everything downstream of it — is bit-identical no matter how arrivals
were batched.

The store also supports *seeding* with public-dataset records to cover the
warm-up phase (paper footnote 3: "In cases where the high-similarity
requests are insufficient ... we augment the searching set with the requests
from public datasets").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["HistoryRecord", "HistoryStore"]

def _sim_band(dim: int) -> float:
    """Half-width of the exact-recheck band around a similarity
    threshold.  BLAS reorders the d-dim reduction differently for
    different batch shapes (a (1, d) @ (d, n) call and a (B, d) @ (d, n)
    call may disagree in the last few ulps), so a raw ``sims >= tau``
    could flip for entries within one reduction-error of tau depending
    on how the query was batched.  Entries inside the band are
    re-decided with a sequential float64 dot, which depends only on the
    stored vectors — making the match set independent of batch shape
    (the batch-ingress parity invariant).  The band must exceed the
    worst-case float32 reduction error for unit vectors, <= dim *
    eps_f32 (~1.5e-5 at dim = 256, ~2.4e-4 at dim = 4096); 4x that —
    never below 1e-4 — leaves a comfortable margin at any dim."""
    return max(1e-4, 4.0 * dim * float(np.finfo(np.float32).eps))


@dataclass(frozen=True)
class HistoryRecord:
    """One completed inference: what the predictor learns from."""

    embedding: np.ndarray  # (dim,) unit vector
    input_len: int
    output_len: int


class HistoryStore:
    """Ring buffer of completed requests + exact cosine search.

    All columns are stored as dense numpy arrays so a similarity query is a
    single (n, d) @ (d,) matvec — the IndexFlatIP equivalent.
    """

    def __init__(self, dim: int, capacity: int = 10_000):
        self.dim = dim
        self.capacity = capacity
        self._band = _sim_band(dim)
        self._emb = np.zeros((capacity, dim), dtype=np.float32)
        self._input_len = np.zeros(capacity, dtype=np.int64)
        self._output_len = np.zeros(capacity, dtype=np.int64)
        self._next = 0  # ring cursor
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, embedding: np.ndarray, input_len: int, output_len: int) -> None:
        """Record one completed request (FIFO eviction past capacity)."""
        i = self._next
        self._emb[i] = embedding
        self._input_len[i] = int(input_len)
        self._output_len[i] = int(output_len)
        self._next = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def add_batch(self, embeddings: np.ndarray, input_lens, output_lens) -> None:
        """Record a batch of completions in one vectorized pass.  FIFO ring
        semantics are identical to the equivalent sequence of ``add`` calls."""
        embs = np.asarray(embeddings, np.float32)
        ins = np.asarray(input_lens, np.int64)
        outs = np.asarray(output_lens, np.int64)
        b = embs.shape[0]
        if b == 0:
            return
        start = self._next
        if b >= self.capacity:
            # only the last ``capacity`` records survive the ring anyway
            embs, ins, outs = (embs[-self.capacity:], ins[-self.capacity:],
                               outs[-self.capacity:])
            start = (self._next + b - self.capacity) % self.capacity
        idx = (start + np.arange(embs.shape[0])) % self.capacity
        self._emb[idx] = embs
        self._input_len[idx] = ins
        self._output_len[idx] = outs
        self._next = (self._next + b) % self.capacity
        self._size = min(self._size + b, self.capacity)

    # ---------------------------------------------------------------- search

    def similarity_batch(self, embeddings: np.ndarray) -> np.ndarray:
        """(B, len(self)) cosine similarities in ONE sgemm — the batched
        IndexFlatIP equivalent (queries are unit vectors, rows too)."""
        q = np.asarray(embeddings, np.float32)
        if self._size == 0:
            return np.zeros((q.shape[0], 0), np.float32)
        return q @ self._emb[: self._size].T

    def threshold_matches(self, sims_row: np.ndarray, embedding: np.ndarray,
                          threshold: float) -> np.ndarray:
        """Indices with cosine similarity >= threshold, decided
        *deterministically*: entries whose approximate similarity falls
        inside the dim-scaled recheck window around the threshold are
        re-decided with a sequential float64 dot, so the result does not
        depend on the batch shape that produced ``sims_row`` (see
        ``_sim_band``)."""
        hit = sims_row >= threshold
        near = np.flatnonzero(np.abs(sims_row - threshold) < self._band)
        if near.size:
            exact = np.cumsum(self._emb[near].astype(np.float64)
                              * embedding.astype(np.float64), axis=1)[:, -1]
            hit[near] = exact >= threshold
        return np.flatnonzero(hit)

    def search_similar(self, embedding: np.ndarray, threshold: float
                       ) -> np.ndarray:
        """Indices of stored records with cosine similarity >= threshold.

        Exact flat search (FAISS IndexFlatIP semantics on unit vectors);
        the B=1 case of ``search_similar_batch``.
        """
        if self._size == 0:
            return np.zeros(0, dtype=np.int64)
        emb = np.asarray(embedding, np.float32)
        return self.threshold_matches(self.similarity_batch(emb[None])[0],
                                      emb, threshold)

    def search_similar_batch(self, embeddings: np.ndarray, thresholds
                             ) -> list[np.ndarray]:
        """Per-query match indices for a (B, dim) query block: one (B, H)
        cosine matmul + deterministic per-row thresholding.  ``thresholds``
        is a scalar or a (B,) array (per-row tau)."""
        q = np.asarray(embeddings, np.float32)
        b = q.shape[0]
        if b == 0 or self._size == 0:
            return [np.zeros(0, dtype=np.int64) for _ in range(b)]
        sims = self.similarity_batch(q)
        thr = np.broadcast_to(np.asarray(thresholds, np.float64), (b,))
        return [self.threshold_matches(sims[i], q[i], float(thr[i]))
                for i in range(b)]

    def search_by_input_len(self, input_len: int, rel_tol: float = 0.2,
                            min_matches: int = 8) -> np.ndarray:
        """Semantic-UNAWARE ablation (Sec. 4.3.1 baseline 1): match by
        input-length proximity instead of prompt content.  The B=1 case of
        ``search_by_input_len_batch``."""
        return self.search_by_input_len_batch([input_len], rel_tol,
                                              min_matches)[0]

    def search_by_input_len_batch(self, input_lens, rel_tol: float = 0.2,
                                  min_matches: int = 8) -> list[np.ndarray]:
        """Per-query input-length-proximity matches for a burst.  Integer
        arithmetic throughout, so batch and scalar results are identical by
        construction (no floating-point reduction involved)."""
        il = np.asarray(input_lens, np.int64)
        b = il.shape[0]
        if b == 0 or self._size == 0:
            return [np.zeros(0, dtype=np.int64) for _ in range(b)]
        lens = self._input_len[: self._size]
        tol = np.maximum(1, (rel_tol * np.maximum(1, il)).astype(np.int64))
        out = []
        for i in range(b):
            diff = np.abs(lens - il[i])
            idx = np.nonzero(diff <= tol[i])[0]
            if idx.size < min_matches:
                # widen to the nearest ``min_matches`` records by |Δ len|
                order = np.argsort(diff, kind="stable")
                idx = order[: min(min_matches, self._size)]
            out.append(idx)
        return out

    def output_lengths(self, indices: np.ndarray) -> np.ndarray:
        return self._output_len[indices]

    def input_lengths(self, indices: np.ndarray) -> np.ndarray:
        return self._input_len[indices]

    def global_output_lengths(self) -> np.ndarray:
        """All recorded output lengths (recent-window marginal)."""
        return self._output_len[: self._size].copy()
