"""Plain PyTorch version of the conditioned batched Gittins kernel (the
port of ``repro/kernels/gittins/ops.py::_attained_op`` over
``ref.py::gittins_reference``), used by the tests and by CPU runs."""

from __future__ import annotations

import torch

__all__ = ["PAD_SUPPORT", "gittins_reference", "gittins_attained_reference"]

# large finite pad for dead support columns: big enough to sit above any
# real cost, small enough that float32 products with ~1 stay finite
PAD_SUPPORT = 1e30


def gittins_reference(support: torch.Tensor,
                      probs: torch.Tensor) -> torch.Tensor:
    """support/probs: (n, k) -> (n,) Gittins indices.  Padded entries
    (prob 0) are masked out, so any finite-or-inf pad support is safe."""
    c = support.float()
    p = probs.float()
    valid = p > 0.0
    cz = torch.where(valid, c, torch.zeros_like(c))
    mass = torch.cumsum(p, dim=1)
    spent = torch.cumsum(cz * p, dim=1)
    num = spent + cz * (1.0 - mass)
    ratio = torch.where(valid & (mass > 1e-12),
                        num / torch.clamp(mass, min=1e-12),
                        torch.full_like(num, float("inf")))
    return ratio.min(dim=1).values


def gittins_attained_reference(support: torch.Tensor, probs: torch.Tensor,
                               attained: torch.Tensor) -> torch.Tensor:
    """Condition rows on X > attained, re-origin, and evaluate; an
    exhausted row (no mass above ``attained``) returns its largest valid
    support, at least 1."""
    c = support.float()
    p = probs.float()
    att = torch.clamp(attained.float(), min=0.0)
    valid = p > 0.0
    cond = (att > 0.0)[:, None]
    alive = valid & (~cond | (c > att[:, None]))
    pa = torch.where(alive, p, torch.zeros_like(p))
    psum = pa.sum(dim=1)
    exhausted = cond[:, 0] & (psum <= 0.0)
    safe = torch.where(psum > 0.0, psum, torch.ones_like(psum))
    pn = torch.where(cond, pa / safe[:, None], pa)
    cr = torch.where(alive, c - att[:, None] * cond,
                     torch.full_like(c, PAD_SUPPORT))
    idx = gittins_reference(cr, pn)
    tail = torch.clamp(torch.where(valid, c, torch.full_like(c, -float("inf"))
                                   ).max(dim=1).values, min=1.0)
    return torch.where(exhausted, tail, idx)
