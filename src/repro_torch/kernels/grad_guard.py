"""The refusal of a serving-only kernel op under autograd on the card.

A decode op writes its result through ``ctypes`` into a fresh tensor,
which has no ``grad_fn``: under autograd its output would be silently
detached, and everything below it would get no gradient.  So each of the
three decode ops calls ``refuse_backward`` first: for a tensor on the
card that requires grad (with grad enabled) it raises
``NotImplementedError`` saying why (``SERVING_ONLY``): training runs
attention through the flash op, which has its backward kernel.  On the
CPU the ops run their plain versions, which stay differentiable.
``on_card`` is the one device check (tests patch it to run the refusal on
the CPU).  The kernel ops that training runs (the flash op, the SSD
scan) go through ``torch.autograd.Function``s with backward kernels
instead.
"""

from __future__ import annotations

import torch

__all__ = ["SERVING_ONLY", "on_card", "refuse_backward"]

SERVING_ONLY = ("the decode ops are serving-only: training runs attention "
                "through the flash op, whose backward is a kernel "
                "(FlashAttentionFunction)")


def on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def refuse_backward(op: str, *tensors) -> None:
    """Raise, saying why (``SERVING_ONLY``), if the first of ``tensors``
    (None skipped) is on the card, grad is enabled and any of them
    requires grad."""
    ts = [t for t in tensors if t is not None]
    if ts and on_card(ts[0]) and torch.is_grad_enabled() \
            and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{op}: no backward kernel on the card (its output would carry "
            f"no gradient); {SERVING_ONLY}")
