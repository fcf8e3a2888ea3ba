"""Weight bridge: the JAX package's parameters, as numpy, into the port.

``params_from_numpy`` takes the nested dict of numpy arrays that
``np.asarray`` gives over the leaves of ``repro``'s ``Model.init`` and
returns the port's params: the same keys and the same stacked layout,
as tensors on ``device``.  Because the layouts agree the bridge is only
a dtype and device move, for every family's tree: an MoE tree keeps its
f32 router beside its bf16 ``(L, E, ...)`` experts, shared experts and
``dense_layers``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _to_tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes adds one): move the
        # raw 16-bit patterns and reinterpret them
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a private, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``.  ``dtype`` (optional) casts every floating leaf; None
    keeps each leaf's own dtype (bf16 weights stay bf16, f32 norm scales
    and biases stay f32)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)
