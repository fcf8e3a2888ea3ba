"""ctypes binding of ``csrc/gittins.cu`` (replaces the Pallas
``repro/kernels/gittins/kernel.py::gittins_kernel``)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["GITTINS_KERNEL"]

_p, _i = ctypes.c_void_p, ctypes.c_int

# gittins_attained(support, probs, attained, out, n, k, stream)
GITTINS_KERNEL = CudaKernel("gittins", "gittins_attained",
                            [_p, _p, _p, _p, _i, _i, _p])
