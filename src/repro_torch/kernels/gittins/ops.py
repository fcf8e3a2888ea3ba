"""Scheduler-facing batched Gittins evaluation.

``gittins_attained_op`` conditions each (n, k) bucketized row on
X > attained and returns its Gittins index.  A CUDA device runs the
hand-written kernel (``csrc/gittins.cu``); the CPU runs the plain
version in ``ref.py``.  Rows are padded to the next power of two (at
least 8) with unit-mass rows first, as the JAX op does, so the kernel
sees the same bounded set of shapes as queue depth breathes.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernel import GITTINS_KERNEL
from .ref import PAD_SUPPORT, gittins_attained_reference

__all__ = ["gittins_attained_op", "gittins_attained", "PAD_SUPPORT",
           "GITTINS_KERNEL", "MAX_K"]

MAX_K = 256          # BatchState max_k; one warp holds at most 8 columns a lane


def _next_pow2(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def gittins_attained(support: torch.Tensor, probs: torch.Tensor,
                     attained: torch.Tensor) -> torch.Tensor:
    """support/probs: (n, k) float32; attained: (n,) float32, all on one
    device.  Returns (n,) float32 on that device."""
    dev = support.device
    if dev.type == "cpu":
        return gittins_attained_reference(support, probs, attained)
    if dev.type != "cuda":
        raise ValueError(f"gittins_attained: unsupported device {dev}")
    n, k = support.shape
    for name, t in (("support", support), ("probs", probs),
                    ("attained", attained)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"gittins_attained: {name} must be a contiguous "
                             f"float32 tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
    if probs.shape != (n, k) or attained.shape != (n,):
        raise ValueError(f"gittins_attained: shapes {tuple(support.shape)}, "
                         f"{tuple(probs.shape)}, {tuple(attained.shape)}")
    if not 0 < k <= MAX_K or n == 0:
        raise ValueError(f"gittins_attained: need 0 < k <= {MAX_K} and n > 0, "
                         f"got n={n} k={k}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    GITTINS_KERNEL(support.data_ptr(), probs.data_ptr(), attained.data_ptr(),
                   out.data_ptr(), n, k,
                   torch.cuda.current_stream(dev).cuda_stream)
    GITTINS_KERNEL.launches += 1
    return out


def gittins_attained_op(support, probs, attained=None, *,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """support/probs: (n, k) bucketized rows (padded entries prob 0);
    attained: optional (n,) consumed cost per row.  Accepts numpy
    arrays; returns a (n,) float32 tensor on ``device``."""
    support = np.asarray(support, np.float32)
    probs = np.asarray(probs, np.float32)
    n, k = support.shape
    if attained is None:
        attained = np.zeros(n, np.float32)
    attained = np.asarray(attained, np.float32)
    n2 = _next_pow2(n)
    if n2 != n:
        pad = n2 - n
        support = np.pad(support, ((0, pad), (0, 0)),
                         constant_values=PAD_SUPPORT)
        support[n:, 0] = 1.0
        probs = np.pad(probs, ((0, pad), (0, 0)))
        probs[n:, 0] = 1.0          # harmless unit-mass rows
        attained = np.pad(attained, (0, pad))
    out = gittins_attained(torch.from_numpy(support).to(device),
                           torch.from_numpy(probs).to(device),
                           torch.from_numpy(attained).to(device))
    return out[:n]
