"""Training-free prompt embeddings for semantic similarity search.

The paper's predictor (Sec. 3.1) needs a light-weight prompt embedding to
retrieve similar historical requests.  The paper reports 0.22 ms per
embedding — i.e. something far cheaper than a transformer forward pass.
We use deterministic feature hashing with sign hashing (a sparse
random-projection-equivalent, training-free embedding) over word unigrams,
word bigrams, and intra-word character n-grams.  Cosine similarity between
two such embeddings approximates the weighted token-multiset overlap of
the prompts, which is exactly the "prompt similarity" signal the paper
exploits (Fig. 4).

This is the TPU/CPU-portable stand-in for the DistillBERT embeddings of
(Qiu et al., 2024): training-free, model-agnostic, sub-millisecond.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["PromptEmbedder"]


class PromptEmbedder:
    """Hash lexical features into a fixed-dimension, L2-normalized vector.

    Features per prompt: word unigrams (weight 1.0), word bigrams (0.5),
    and character 4-grams inside words (0.25, for morphological overlap).
    Deterministic (seeded by ``salt``), stateless, and cheap: one pass over
    the text, two CRC32-derived values per feature (index + sign).
    """

    def __init__(self, dim: int = 256, salt: int = 0x5A6E,
                 bigram_weight: float = 0.5, chargram_weight: float = 0.25):
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        self.dim = dim
        self.salt = salt
        self.bigram_weight = bigram_weight
        self.chargram_weight = chargram_weight
        self._salt_bytes = salt.to_bytes(4, "little")

    def _add(self, vec: np.ndarray, feature: str, weight: float) -> None:
        h = zlib.crc32(feature.encode("utf-8", "ignore") + self._salt_bytes)
        sign = 1.0 if (h >> 16) & 1 else -1.0
        vec[h % self.dim] += sign * weight

    def embed(self, text: str) -> np.ndarray:
        """Embed one prompt. Returns float32 unit vector of shape (dim,)."""
        vec = np.zeros(self.dim, dtype=np.float32)
        words = text.lower().split()
        for w in words:
            self._add(vec, "u:" + w, 1.0)
            if self.chargram_weight > 0.0:
                for i in range(len(w) - 3):
                    self._add(vec, "c:" + w[i:i + 4], self.chargram_weight)
        if self.bigram_weight > 0.0:
            for a, b in zip(words, words[1:]):
                self._add(vec, "b:" + a + " " + b, self.bigram_weight)
        norm = float(np.linalg.norm(vec))
        if norm > 0.0:
            vec /= norm
        return vec

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        """Embed a batch of prompts. Returns (len(texts), dim) float32."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.embed(t) for t in texts])
