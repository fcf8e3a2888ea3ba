"""Scheduler-facing batched Gittins evaluation.

``gittins_attained`` conditions each (n, k) bucketized row on
X > attained and returns its Gittins index.  A CUDA device runs the
hand-written kernel (``csrc/gittins.cu``); the CPU runs the plain
version in ``ref.py``.  The kernel takes rows of k2 = max(8, pow2(k))
columns; the op pads the columns with prob 0, which is exact (dead
columns are inert in both prefix sums and in the tail).

Two host entry points:

* ``gittins_attained_op`` pads the rows to the next power of two (at
  least 8) with unit-mass rows, as the JAX op does, and the columns to
  k2, then returns a tensor.
* ``GittinsRefresh`` is the scheduler's refresh path (numpy float64 in,
  numpy float64 out), the one ``CudaPriorityBackend`` uses.  It owns its
  staging: a pinned host buffer and a device buffer, both laid out
  ``[support (n2, k2) | probs (n2, k2) | attained (n2) | out (n2)]`` and
  grown along the pow2 ladder, so the set of shapes stays bounded as the
  queue breathes.  A refresh writes the caller's rows straight into the
  pinned buffer, rewrites the pad rows and columns (``stage_rows``, the
  one statement of the padding, which ``padded_rows`` and
  ``gittins_attained_op`` share), then queues one host-to-device copy,
  one launch and one device-to-host copy of n floats on a side stream
  (``csrc/gittins.cu::gittins_refresh``), and waits on its own event
  only.  On the CPU the same buffer feeds the plain version.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .kernel import GITTINS_KERNEL, GITTINS_REFRESH
from .ref import PAD_SUPPORT, gittins_attained_reference

__all__ = ["gittins_attained_op", "gittins_attained", "GittinsRefresh",
           "shared_refresh", "stage_rows", "padded_rows", "PAD_SUPPORT",
           "GITTINS_KERNEL", "MAX_K"]

MAX_K = 256          # BatchState max_k; the kernel's widest instance


def _next_pow2(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _check_k(n: int, k: int, who: str) -> None:
    if not 0 < k <= MAX_K or n == 0:
        raise ValueError(f"{who}: need 0 < k <= {MAX_K} and n > 0, "
                         f"got n={n} k={k}")


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
    _check_k(n, k, "gittins_attained")
    k2 = _next_pow2(k)
    if k2 != k:
        support = F.pad(support, (0, k2 - k), value=PAD_SUPPORT)
        probs = F.pad(probs, (0, k2 - k))
    if (support.data_ptr() | probs.data_ptr()) % 16:
        raise ValueError("gittins_attained: support and probs must be "
                         "16-byte aligned")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    GITTINS_KERNEL(support.data_ptr(), probs.data_ptr(), attained.data_ptr(),
                   out.data_ptr(), n, k2,
                   torch.cuda.current_stream(dev).cuda_stream)
    GITTINS_KERNEL.launches += 1
    return out


def stage_rows(sup, prb, att, support, probs, attained) -> None:
    """Write (n, k) support and probs and (n,) attained (None: zeros)
    into (n2, k2) views sup and prb and (n2,) view att, n2 >= n and
    k2 >= k, in the kernel's padding: columns k.. at prob 0, rows n..
    harmless unit-mass rows.  Every pad entry is rewritten, so a reused
    buffer leaks none of an earlier call's rows or columns."""
    n, k = np.shape(support)
    n2, k2 = sup.shape
    np.copyto(sup[:n, :k], support, casting="unsafe")
    np.copyto(prb[:n, :k], probs, casting="unsafe")
    if attained is None:
        att[:n] = 0.0
    else:
        np.copyto(att[:n], attained, casting="unsafe")
    if k < k2:
        sup[:n, k:] = PAD_SUPPORT
        prb[:n, k:] = 0.0
    if n < n2:
        sup[n:] = PAD_SUPPORT
        sup[n:, 0] = 1.0
        prb[n:] = 0.0
        prb[n:, 0] = 1.0
        att[n:] = 0.0


def padded_rows(support, probs, attained=None):
    """(support, probs, attained) as new float32 arrays of (n2, k2),
    (n2, k2) and (n2,), padded by ``stage_rows`` to the pow2 ladder
    (n2, k2 >= 8)."""
    n, k = np.shape(support)
    n2, k2 = _next_pow2(n), _next_pow2(k)
    out = (np.empty((n2, k2), np.float32), np.empty((n2, k2), np.float32),
           np.empty(n2, np.float32))
    stage_rows(*out, support, probs, attained)
    return out


def gittins_attained_op(support, probs, attained=None, *,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """support/probs: (n, k) bucketized rows (padded entries prob 0);
    attained: optional (n,) consumed cost per row.  Accepts numpy
    arrays; pads them with ``padded_rows`` and returns a (n,) float32
    tensor on ``device``."""
    n = np.shape(support)[0]
    out = gittins_attained(*(torch.from_numpy(x).to(device)
                             for x in padded_rows(support, probs, attained)))
    return out[:n]


def _offsets(n2: int, k2: int) -> tuple[int, int, int, int, int]:
    """Float offsets of support, probs, attained and out in a staging
    buffer, and its size."""
    a = n2 * k2
    return 0, a, 2 * a, 2 * a + n2, 2 * a + 2 * n2


def _layout(flat, n2: int, k2: int):
    """(support, probs, attained, out) views of a staging buffer."""
    s, p, a, o, end = _offsets(n2, k2)
    return (flat[s:p].reshape(n2, k2), flat[p:a].reshape(n2, k2),
            flat[a:o], flat[o:end])


class GittinsRefresh:
    """The staged refresh on one device: a call with (n, k) support and
    probs and (n,) attained (any float dtype; attained may be None)
    returns the (n,) float64 indices.

    The inputs come from the host, so the side stream waits for nothing
    the caller queued.  A call waits for its own event before it returns,
    so the buffers are free again when the next call writes them."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"GittinsRefresh: unsupported device "
                             f"{self.device}")
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._done = torch.cuda.Event()
        self._host = self._dev = None
        self._host_np = None
        self._lock = threading.Lock()   # one refresh at a time per buffer

    def _staging(self, size: int) -> None:
        if self._host is not None and self._host.numel() >= size:
            return
        self._host = torch.empty(size, dtype=torch.float32,
                                 pin_memory=self._cuda)
        self._host_np = self._host.numpy()
        if self._cuda:
            with torch.cuda.stream(self._stream):
                self._dev = torch.empty(size, dtype=torch.float32,
                                        device=self.device)

    def __call__(self, support, probs, attained=None) -> np.ndarray:
        n, k = np.shape(support)
        if np.shape(probs) != (n, k) or (attained is not None
                                         and np.shape(attained) != (n,)):
            raise ValueError(f"GittinsRefresh: shapes {np.shape(support)}, "
                             f"{np.shape(probs)}, {np.shape(attained)}")
        if n == 0:
            return np.zeros(0)
        _check_k(n, k, "GittinsRefresh")
        with self._lock:
            return self._refresh(support, probs, attained, n, k)

    def _refresh(self, support, probs, attained, n: int, k: int):
        n2, k2 = _next_pow2(n), _next_pow2(k)
        offs = _offsets(n2, k2)
        self._staging(offs[-1])
        sup, prb, att, out = _layout(self._host_np, n2, k2)
        stage_rows(sup, prb, att, support, probs, attained)
        if not self._cuda:
            views = _layout(self._host, n2, k2)
            res = gittins_attained_reference(*views[:3])[:n]
            return res.numpy().astype(np.float64)
        # one copy in, the kernel, one copy of n floats out: queued in one
        # C call (torch's copy_ costs more host time than the card's work)
        host, dev = self._host.data_ptr(), self._dev.data_ptr()
        sup_at, prb_at, att_at, out_at = (dev + 4 * o for o in offs[:4])
        GITTINS_REFRESH(host, dev, 4 * offs[3], sup_at, prb_at, att_at,
                        out_at, host + 4 * offs[3], n, n2, k2,
                        self._stream.cuda_stream)
        GITTINS_KERNEL.launches += 1
        self._done.record(self._stream)
        self._done.synchronize()
        return out[:n].astype(np.float64)


def shared_refresh(device: str | torch.device = "cuda") -> GittinsRefresh:
    """The refresh of ``device``, one per device for the process."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _shared(device)


@functools.cache
def _shared(device: torch.device) -> GittinsRefresh:
    return GittinsRefresh(device)
