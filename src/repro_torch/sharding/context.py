"""Serving hooks of tensor-parallel decode (the serving half of
``repro.sharding.context``), as thread-local state.

The engine installs its ``serving.sharded.ShardingPlan`` around its model
calls (``serving_sharding``); the model reads the hooks below.  Outside a
serving context each hook is the identity (or 1, or None), so an engine
without a mesh, or any other caller, is untouched.  The reference's hooks
are sharding constraints that GSPMD turns into a dataflow; the port has
no GSPMD, so its hooks do the relayout themselves: they cut a tensor into
per-shard pieces on the shards' devices, or gather pieces back onto the
plan's first device.  The training hooks (``activation_sharding``,
``constrain_activations`` and the rest) are ROADMAP Queue A 13.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["serving_sharding", "serving_plan", "gather_model",
           "constrain_q_heads", "constrain_kv_heads", "attn_split_count",
           "constrain_attn_split"]

_state = threading.local()


def serving_plan():
    """The installed plan, or None outside a serving context."""
    return getattr(_state, "plan", None)


def gather_model(parts, dim: int):
    """All-gather: per-shard pieces concatenated along ``dim`` on the
    plan's first device (a pure relayout, so exact).  A single tensor (no
    serving context) passes through."""
    plan = serving_plan()
    if plan is None or not isinstance(parts, (list, tuple)):
        return parts
    return plan.all_gather(parts, dim)


def constrain_q_heads(q):
    """Cut a (B, S, H, dh) query into the per-shard slices of the pool's
    kv-head sharding (shard s: the query heads of its kv heads), each on
    its shard's device.  ``[q]`` outside a serving context."""
    plan = serving_plan()
    return [q] if plan is None else plan.split_heads(q, q_heads=True)


def constrain_kv_heads(x):
    """Cut a (..., KV, dh) key or value into the per-shard kv-head slices
    of the pool, each on its shard's device.  ``[x]`` outside a serving
    context."""
    plan = serving_plan()
    return [x] if plan is None else plan.split_heads(x, q_heads=False)


def attn_split_count() -> int:
    """Stripes of the logical page axis in paged decode attention
    (``models.attention.decode_attention_paged``): 1 outside a serving
    context; the efficient plan installs tp when the kv heads do not
    divide the mesh."""
    plan = serving_plan()
    return 1 if plan is None else int(plan.attn_splits)


def constrain_attn_split(pools):
    """The (k_pool, v_pool) pair each LSE stripe runs on: stripe s on
    shard s's copy of the replicated pool.  ``pools`` is the per-shard
    list of one layer's pairs; None (every stripe on the one pool)
    outside a serving context."""
    plan = serving_plan()
    return None if plan is None else list(pools)


@contextlib.contextmanager
def serving_sharding(plan):
    """Install ``plan``'s hooks for the duration of the block (scoped, so
    engines without a mesh in the same thread never see them)."""
    prev = getattr(_state, "plan", None)
    _state.plan = plan
    try:
        yield
    finally:
        _state.plan = prev
