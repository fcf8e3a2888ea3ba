"""Pluggable priority-evaluation backends for the batched scheduler.

The array-native refresh path (``Scheduler.refresh``) hands each policy a
``BatchView`` — parallel arrays over the dirty subset of live requests —
plus one of these backends, which own the actual batched index math:

  * ``NumpyPriorityBackend``  — float64 vectorized numpy; bit-identical
    to the scalar per-request oracle (``gittins_index`` applied to
    ``CostDistribution.shift``), which is what makes object-path vs
    batch-path simulations reproduce identical schedules.
  * ``CudaPriorityBackend``   — the hand-written CUDA Gittins kernel
    from ``repro_torch.kernels.gittins.ops`` (its plain torch version
    when the backend's device is the CPU), with the same power-of-two
    batch padding as the JAX package's Pallas backend.  float32:
    priorities agree with the oracle to ~1e-5 relative, not bitwise.

``make_priority_backend`` resolves "numpy" / "cuda" (and "object",
which the Scheduler intercepts before ever reaching a backend).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .gittins import gittins_index_batch, mean_index_batch

__all__ = ["BatchView", "PriorityBackend", "NumpyPriorityBackend",
           "CudaPriorityBackend", "make_priority_backend", "BACKEND_NAMES"]


class BatchView(NamedTuple):
    """Structure-of-arrays slice handed to ``Policy.priority_batch``.

    (n, k) arrays hold bucketized distributions: supports non-decreasing
    along axis 1, padded columns carry prob 0 (support repeats its last
    real value, so row maxima and quantile lookups stay correct).
    """

    cost_sup: np.ndarray    # (n, k) cost support
    cost_probs: np.ndarray  # (n, k) cost probabilities
    len_sup: np.ndarray     # (n, k) output-length support
    len_probs: np.ndarray   # (n, k) output-length probabilities
    generated: np.ndarray   # (n,) output tokens produced
    attained: np.ndarray    # (n,) cost consumed so far
    arrival: np.ndarray     # (n,) arrival timestamps (tie-break encoded)
    input_len: np.ndarray   # (n,) prompt lengths


class PriorityBackend:
    """Batched evaluators for the two cost-distribution indices."""

    name = "base"

    def gittins(self, support, probs, attained) -> np.ndarray:
        raise NotImplementedError

    def mean(self, support, probs, attained) -> np.ndarray:
        raise NotImplementedError


class NumpyPriorityBackend(PriorityBackend):
    """float64 numpy; the reference batched backend."""

    name = "numpy"

    def gittins(self, support, probs, attained) -> np.ndarray:
        return gittins_index_batch(support, probs, attained)

    def mean(self, support, probs, attained) -> np.ndarray:
        return mean_index_batch(support, probs, attained)


class CudaPriorityBackend(PriorityBackend):
    """Gittins indices through the CUDA kernel on ``device`` (the plain
    torch version when ``device`` is the CPU); the mean index stays
    numpy — it is a single cumsum and never the bottleneck."""

    name = "cuda"

    def __init__(self, device: str = "cuda"):
        # imported lazily so repro_torch.core stays importable without torch
        from ..kernels.gittins.ops import gittins_attained_op
        self._op = gittins_attained_op
        self.device = device

    def gittins(self, support, probs, attained) -> np.ndarray:
        out = self._op(support, probs, attained, device=self.device)
        return out.cpu().numpy().astype(np.float64)

    def mean(self, support, probs, attained) -> np.ndarray:
        return mean_index_batch(support, probs, attained)


BACKEND_NAMES = ("object", "numpy", "cuda")


def make_priority_backend(name, **kwargs) -> PriorityBackend | None:
    """Resolve a backend spec: an instance passes through; "object"
    returns None (the Scheduler keeps the scalar per-request path)."""
    if isinstance(name, PriorityBackend):
        return name
    if name is None or name == "object":
        return None
    if name == "numpy":
        return NumpyPriorityBackend()
    if name == "cuda":
        return CudaPriorityBackend(**kwargs)
    raise KeyError(f"unknown priority backend {name!r}; have {BACKEND_NAMES}")
