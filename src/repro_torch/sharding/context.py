"""Activation-sharding hooks of training and serving hooks of
tensor-parallel decode (the port of ``repro.sharding.context``), as
thread-local state.

Training: the model calls ``constrain_activations`` at block boundaries,
``constrain_heads`` on the projected queries and the attention output,
``constrain_inner`` on the Mamba2 inner projections,
``constrain_ssm_state`` on the SSD scan's state and
``constrain_expert_buf`` on the MoE capacity buffer.  Outside
``activation_sharding`` each is the identity.  Inside, each holds its
tensor to the installed ``partitioning.NamedSharding``: the identity on
the meta device (the dry-run's shape pass) and where every mesh axis the
spec names has size 1 (the launcher's 1x1 mesh); a spec that names a
larger axis over real devices raises ``NotImplementedError``, since the
port has no GSPMD to lay the tensor out and training across cards is
ROADMAP Queue A 15.  It never replicates silently.

Serving: the engine installs its ``serving.sharded.ShardingPlan`` around
its model calls (``serving_sharding``); the model reads the hooks below.
Outside a serving context each hook is the identity (or 1, or None), so
an engine without a mesh, or any other caller, is untouched.  The reference's hooks
are sharding constraints that GSPMD turns into a dataflow; the port has
no GSPMD, so its hooks do the relayout themselves: they cut a tensor into
per-shard pieces on the shards' devices, or gather pieces back onto the
plan's first device.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["activation_sharding", "constrain_activations", "constrain_heads",
           "constrain_inner", "constrain_ssm_state", "serving_sharding",
           "serving_plan", "gather_model", "constrain_q_heads",
           "constrain_kv_heads", "constrain_expert_buf", "attn_split_count",
           "constrain_attn_split"]

_state = threading.local()

_TRAIN_KEYS = ("spec", "heads_spec", "inner_spec", "state_spec",
               "expert_spec")


def _constrain(x, key: str):
    """``x`` held to the installed training sharding ``key`` (see the
    module docstring)."""
    sharding = getattr(_state, key, None)
    if sharding is None or x.device.type == "meta":
        return x
    wide = sharding.wide()
    if wide:
        raise NotImplementedError(
            f"activation sharding {sharding.spec} names mesh axes of size "
            f"> 1 ({wide}) over real devices: the port lays out no "
            "activation across devices; training across cards is ROADMAP "
            "Queue A 15")
    return x


def constrain_activations(h):
    """A (batch, seq, d_model) residual-stream activation (sequence
    parallelism in the reference's big-model training)."""
    return _constrain(h, "spec")


def constrain_heads(x):
    """A (batch, seq, heads, head_dim) query or attention output, head
    sharded in the reference's training."""
    return _constrain(x, "heads_spec")


def constrain_inner(x):
    """A (batch, seq, d_inner) Mamba2 inner projection, inner dim over
    'model' in the reference's training."""
    return _constrain(x, "inner_spec")


def constrain_ssm_state(x):
    """The (B, H, P, N) SSD scan state, heads over 'model' in the
    reference's training."""
    return _constrain(x, "state_spec")


@contextlib.contextmanager
def activation_sharding(spec, heads_spec=None, inner_spec=None,
                        state_spec=None, expert_spec=None):
    """Install the training hooks' shardings (``NamedSharding`` or None
    each): ``spec`` for (batch, seq, d_model) activations, ``heads_spec``
    for (batch, seq, heads, head_dim), ``inner_spec`` for (batch, seq,
    d_inner), ``state_spec`` for the SSD state, ``expert_spec`` for the
    (E, C, D) capacity buffer.  The previous state comes back on exit."""
    prev = [getattr(_state, k, None) for k in _TRAIN_KEYS]
    for k, v in zip(_TRAIN_KEYS, (spec, heads_spec, inner_spec, state_spec,
                                  expert_spec)):
        setattr(_state, k, v)
    try:
        yield
    finally:
        for k, v in zip(_TRAIN_KEYS, prev):
            setattr(_state, k, v)


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


def constrain_expert_buf(buf):
    """Cut an (E, C, D) MoE capacity buffer into the per-shard expert
    slices of an expert-parallel plan (shard s: experts [s E/tp,
    (s+1) E/tp)), each on its shard's device.  ``[buf]`` outside a
    serving context or where the experts do not shard; outside a serving
    context the buffer is first held to the training ``expert_spec``."""
    plan = serving_plan()
    if plan is None:
        return [_constrain(buf, "expert_spec")]
    return plan.split_experts(buf)


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
