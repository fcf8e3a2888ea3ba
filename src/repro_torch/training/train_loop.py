"""Training step factory: gradient accumulation and AdamW, the port of
``repro.training.train_loop``.

``make_train_step(model, optimizer, lr_schedule)`` returns ``(params,
opt_state, batch) -> (params, opt_state, metrics)``: the gradients of
``model.loss_fn`` by ``torch.autograd.grad`` over the parameter leaves (in
the reference's sorted-key tree order), over ``cfg.grad_accum``
microbatches summed in the parameter dtype and divided by their count,
then one AdamW update at the schedule's scale for ``opt_state.count``
(read before the update).  Loss and metrics are the microbatches' means.
On the card, attention's gradients come from the flash backward kernel
(``kernels.flash_attention.ops.FlashAttentionFunction``); the layers run
under ``cfg.remat``.
"""

from __future__ import annotations

import math

import torch

from ..tree import tree_leaves, tree_unflatten
from .optimizer import AdamW, AdamWState

__all__ = ["make_train_step", "make_lr_schedule", "loss_and_grads"]


def make_lr_schedule(base_lr: float = 3e-4, warmup: int = 100,
                     total: int = 10_000, min_frac: float = 0.1):
    """Linear warmup + cosine decay, as a scale factor on base_lr (an f32
    scalar tensor, on the step's device when ``step`` is a tensor)."""
    def scale(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(1.0, warmup), max=1.0)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos
    return scale


def loss_and_grads(model, params, batch):
    """``model.loss_fn`` at ``params`` and its gradients: (loss, metrics,
    grads), the grads a tuple in ``tree_leaves(params)`` order."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = model.loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, optimizer: AdamW, lr_schedule=None):
    cfg = model.cfg
    accum = max(1, cfg.grad_accum)
    lr_schedule = lr_schedule or (lambda step: 1.0)

    def train_step(params, opt_state: AdamWState, batch):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            micro = [{k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum)]
            grads, losses, metricses = None, [], []
            for mb in micro:
                loss_i, mt, g = loss_and_grads(model, params, mb)
                grads = list(g) if grads is None else \
                    [a + b.to(a.dtype) for a, b in zip(grads, g)]
                losses.append(loss_i)
                metricses.append(mt)
            grads = [g / accum for g in grads]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        params, opt_state = optimizer.update(
            tree_unflatten(params, grads), opt_state, params,
            lr_scale=lr_schedule(opt_state.count))
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
