"""ctypes bindings of ``csrc/ssd_scan.cu`` (replaces the Pallas
``repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel``) and of the backward
kernel ``csrc/ssd_scan_bwd.cu`` (which the Pallas package has no twin of:
the reference differentiates the jnp ``ssd_chunked`` through XLA)."""

from __future__ import annotations

import ctypes

from ..build import CudaKernel

__all__ = ["SSD_SCAN_KERNEL", "SSD_BACKWARD_KERNEL"]

_p, _i = ctypes.c_void_p, ctypes.c_int

# ssd_scan(x, dt, a, bm, cm, init_state, y, final_state, cd, cb, ds, sin,
#          B, S, H, P, N, q, stream): four launches (C.B^T, chunk states,
#          state pass, chunk scan), counted as one call
SSD_SCAN_KERNEL = CudaKernel(
    "ssd_scan", "ssd_scan", [_p] * 12 + [_i] * 6 + [_p])

# ssd_scan_backward(x, dt, a, bm, cm, init_state, dy, dstate, dx, ddt, da,
#                   dbm, dcm, dinit, cd, gt, own, parts, last, rows, pairs,
#                   B, S, H, P, N, q, stream): seven launches, counted as
#                   one call
SSD_BACKWARD_KERNEL = CudaKernel(
    "ssd_scan_bwd", "ssd_scan_backward", [_p] * 21 + [_i] * 6 + [_p])
