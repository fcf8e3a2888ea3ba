"""AdamW over the port's parameter trees (nested dicts of tensors), the
port of ``repro.training.optimizer`` with its arithmetic, not
``torch.optim.AdamW``'s: f32 math with the bias corrections ``1 - b^count``
taken in f32, ``step = mhat / (sqrt(vhat) + eps)``, decoupled weight decay
only on leaves of two or more dims, the results cast back to the
parameter's and the moment's dtypes.  ``moment_dtype`` (the config's) lets
the largest models keep m and v in bf16.  Functional, as the reference:
``update`` returns new parameters and a new state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWState", "AdamW"]


class AdamWState(NamedTuple):
    count: torch.Tensor      # () int32, updates applied so far
    m: dict
    v: dict


@dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"
    # leaves above this many elements with three or more dims are updated
    # one leading slice (layer) at a time, as the reference's lax.map does,
    # so that the f32 temporaries stay one layer in size; no result changes
    chunk_threshold: int = 32 * 2**20  # elements

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        first = tree_leaves(params)[0]
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params))

    def update(self, grads, state: AdamWState, params, lr_scale=1.0):
        """Returns (new_params, new_state).  All math in f32, cast back."""
        count = state.count + 1
        c32 = count.float()
        b1c = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                           device=c32.device), c32)
        b2c = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                           device=c32.device), c32)
        if not torch.is_tensor(lr_scale):
            lr_scale = torch.tensor(lr_scale, dtype=torch.float32,
                                    device=c32.device)
        lr = self.learning_rate * lr_scale.float()

        def math(p, g, m, v, decay):
            g32 = g.float()
            m32 = self.b1 * m.float() + (1 - self.b1) * g32
            v32 = self.b2 * v.float() + (1 - self.b2) * g32 * g32
            mhat = m32 / b1c
            vhat = v32 / b2c
            step = mhat / (torch.sqrt(vhat) + self.eps)
            if decay:  # decoupled weight decay on matrices only
                step = step + self.weight_decay * p.float()
            newp = (p.float() - lr * step).to(p.dtype)
            return newp, m32.to(m.dtype), v32.to(v.dtype)

        def upd(p, g, m, v):
            decay = p.dim() >= 2
            if p.numel() > self.chunk_threshold and p.dim() >= 3:
                out = tuple(torch.empty_like(t) for t in (p, m, v))
                for i in range(p.shape[0]):
                    for o, r in zip(out, math(p[i], g[i], m[i], v[i], decay)):
                        o[i] = r
                return out
            return math(p, g, m, v, decay)

        out = tree_map(upd, params, grads, state.m, state.v)
        new_p, m, v = (tree_map(lambda o: o[j], out) for j in range(3))
        return new_p, AdamWState(count=count, m=m, v=v)
