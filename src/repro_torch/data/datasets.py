"""Synthetic token datasets + batching pipeline for training examples.

``lm_batches`` yields an infinite stream of (tokens, labels) LM batches
with a learnable structure (copy/induction patterns + Zipfian unigrams),
so a ~100M model visibly reduces loss within a few hundred steps — the
end-to-end training example's acceptance signal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lm_batches", "zipf_tokens"]


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids in [3, vocab)."""
    raw = rng.zipf(alpha, size=n).astype(np.int64)
    return 3 + (raw - 1) % (vocab - 3)


def lm_batches(vocab_size: int, batch: int, seq_len: int, seed: int = 0):
    """Infinite iterator of {"tokens","labels"} int32 arrays (B, S).

    Each sequence mixes Zipf unigrams with repeated motifs (induction
    heads' favorite snack), so next-token loss has learnable signal.
    """
    rng = np.random.default_rng(seed)
    while True:
        toks = zipf_tokens(rng, batch * seq_len, vocab_size
                           ).reshape(batch, seq_len)
        # plant copy motifs: seq[i : i+k] = seq[j : j+k]
        for b in range(batch):
            for _ in range(max(1, seq_len // 64)):
                k = int(rng.integers(4, 12))
                if seq_len <= 2 * k + 2:
                    continue
                j = int(rng.integers(0, seq_len - 2 * k - 1))
                i = int(rng.integers(j + k, seq_len - k))
                toks[b, i:i + k] = toks[b, j:j + k]
        toks = toks.astype(np.int32)
        yield {"tokens": toks, "labels": toks.copy()}
