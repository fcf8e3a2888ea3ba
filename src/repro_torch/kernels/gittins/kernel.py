"""ctypes binding of ``csrc/gittins.cu`` (replaces the Pallas
``repro/kernels/gittins/kernel.py::gittins_kernel``)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["GITTINS_KERNEL", "GITTINS_REFRESH"]

_p, _i = ctypes.c_void_p, ctypes.c_int

# gittins_attained(support, probs, attained, out, n, k, stream)
GITTINS_KERNEL = CudaKernel("gittins", "gittins_attained",
                            [_p, _p, _p, _p, _i, _i, _p])
# gittins_refresh(host_in, dev_in, in_bytes, support, probs, attained, out,
#                 host_out, n_out, n, k, stream): the same kernel behind one
# copy each way (the staged refresh); its launches count on GITTINS_KERNEL
GITTINS_REFRESH = CudaKernel("gittins", "gittins_refresh",
                             [_p, _p, ctypes.c_size_t, _p, _p, _p, _p, _p,
                              _i, _i, _i, _p])
