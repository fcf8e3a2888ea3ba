"""npz checkpoints of the port's parameter and optimizer trees, in the
reference's flat-key format (``repro.training.checkpoint``): one entry per
leaf under its ``/``-joined path, dict keys in sorted order, the
``AdamWState`` fields in order (``params/...``, ``opt/count``,
``opt/m/...``, ``opt/v/...``) and ``__step__``; bf16 is written as f32.
Files written by either package load in the other.  Written to
``<path>.tmp.npz`` first, then moved into place (atomic).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..tree import tree_items, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint"]

_SEP = "/"


def _as_tree(state):
    """A NamedTuple (``AdamWState``) as the dict of its fields, whose
    sorted order is the field order (``count``, ``m``, ``v``)."""
    return state._asdict() if hasattr(state, "_fields") else state


def _flatten(tree, prefix: str) -> dict:
    out = {}
    for path, t in tree_items(_as_tree(tree)):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[_SEP.join((prefix,) + path)] = t.cpu().numpy()
    return out


def save_checkpoint(path: str, params, opt_state=None, step: int = 0) -> None:
    flat = {"__step__": np.asarray(step)}
    flat.update(_flatten(params, "params"))
    if opt_state is not None:
        flat.update(_flatten(opt_state, "opt"))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _restore(template, data, prefix: str):
    tree = _as_tree(template)
    out = tree_unflatten(tree, [
        torch.from_numpy(np.asarray(data[_SEP.join((prefix,) + path)]).copy())
        .to(device=t.device, dtype=t.dtype) for path, t in tree_items(tree)])
    return type(template)(**out) if hasattr(template, "_fields") else out


def load_checkpoint(path: str, params_like, opt_like=None):
    """Restore into the structure of the ``params_like`` / ``opt_like``
    templates, each leaf in its template's dtype and on its device.
    Returns (params, opt_state or None, step)."""
    with np.load(path) as data:
        step = int(data["__step__"])
        params = _restore(params_like, data, "params")
        opt = None if opt_like is None else _restore(opt_like, data, "opt")
    return params, opt, step
