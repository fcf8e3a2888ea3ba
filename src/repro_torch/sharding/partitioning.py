"""Logical-axis -> mesh-axis resolution per architecture and mode (the
port of ``repro.sharding.partitioning``).

Parameters are declared with logical axes (``models.layers.ParamSpec``);
this module maps them onto the axes of a mesh.  The port has no GSPMD: a
resolved spec is a tuple of mesh-axis names (or None, or a tuple of
names) per dim, entry for entry the reference's ``PartitionSpec``.  Three
rule sets, as the reference's:

  * train:     tensor parallel over 'model' (FSDP configs also store the
               'embed' weight dim over 'data', or ('pod', 'data'));
  * serve:     tensor parallel over 'model', weights replicated over 'data';
  * serve_big: like serve, with 'embed' over 'data' too (2-D weight storage
               for the models whose weights exceed one device at 16-way);

plus the serving-decode rules (``decode_rule_table``) that
``serving.sharded.ShardingPlan`` cuts the weights and the KV pool by,
writing out the collectives itself.  Everything here is pure arithmetic
over configs, templates and a mesh's ``axis_names`` and ``shape``: no
device is touched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_items

__all__ = ["MEGATRON_AXES", "megatron_axes", "batch_axes", "rules_for",
           "decode_rule_table", "decode_rules", "paged_kv_pool_spec",
           "resolve_specs", "pspec", "kv_cache_spec", "ssm_state_spec",
           "logits_spec", "NamedSharding", "named_shardings",
           "shard_bytes_table"]

# The Megatron axis table: every logical parameter axis that tensor
# parallelism splits.  vocab/heads/kv/mlp are column-parallel output dims;
# heads_out and the mlp w_out contraction are row-parallel (psum after);
# expert is expert-parallel; ssm_inner splits the Mamba2 inner projection.
MEGATRON_AXES = ("vocab", "heads", "heads_out", "kv", "mlp", "expert",
                 "ssm_inner")


def megatron_axes(axis: str = "model") -> dict:
    """Base logical-axis -> mesh-axis map with every Megatron axis
    assigned to ``axis`` and everything else replicated."""
    rules = {a: None for a in ("vocab", "heads", "heads_out", "kv", "mlp",
                               "expert", "expert_mlp", "router",
                               "ssm_inner", "embed", "layers", None)}
    for a in MEGATRON_AXES:
        rules[a] = axis
    return rules


def batch_axes(mesh, global_batch: int | None = None):
    """Mesh axes the global batch shards over: ('pod', 'data') or
    ('data',) where the mesh has them, ('data',) alone when the batch does
    not divide both, None when it divides neither (batch-1 long-context
    decode)."""
    ax = [a for a in ("pod", "data") if a in tuple(mesh.axis_names)]
    if not ax:
        return None
    if global_batch is not None:
        size = math.prod(mesh.shape[a] for a in ax)
        if global_batch % size != 0:
            if global_batch % mesh.shape["data"] == 0:
                return ("data",)
            return None
    return tuple(ax)


def rules_for(cfg, mode: str, mesh) -> dict:
    """The logical-axis -> mesh-axis map of ``mode`` ('train', 'serve' or
    'serve_big'): the Megatron axes over 'model' ('kv' replicated when the
    config has fewer kv heads than ``model_parallel``), and 'embed' over
    the data axes for FSDP training and for serve_big."""
    has_pod = "pod" in tuple(mesh.axis_names)
    rules = megatron_axes("model")
    if cfg.n_kv_heads < cfg.model_parallel:
        rules["kv"] = None
    if mode == "train" and cfg.fsdp:
        rules["embed"] = ("pod", "data") if has_pod else "data"
    if mode == "serve_big":
        rules["embed"] = "data"
    return rules


def decode_rule_table(cfg, tp: int, axis: str = "model",
                      parallel: str = "exact"):
    """Mesh-free serving-decode rules: ``(rules, report)`` from the config
    and an integer tensor-parallel width, as the reference computes them.

    ``parallel="exact"`` shards only the paged KV pool over kv heads (and
    MoE experts): no floating-point contraction crosses a shard and every
    GEMM keeps its unsharded shape, so the result is bit-identical to one
    device.  ``parallel="efficient"`` is the Megatron set: column-parallel
    wq/wk/wv and MLP up/gate, row-parallel wo/down (one psum each),
    vocab-sharded embedding and logits; when the kv heads do not divide,
    attention falls back to an LSE split of the logical page axis
    (``report["attn_splits"] = tp``).  A component whose dimension does
    not divide ``tp`` stays replicated, and its axes are listed in
    ``report["fallbacks"]``.  The pool's mesh axis travels in the extra
    ``"pool_kv"`` key (see ``paged_kv_pool_spec``)."""
    if parallel not in ("exact", "efficient"):
        raise ValueError(f"bad parallel mode {parallel!r} "
                         "(expected 'exact' or 'efficient')")
    heads_ok = cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    expert_ok = cfg.n_experts % tp == 0 if cfg.family == "moe" else False
    rules = {a: None for a in megatron_axes(axis)}
    rules["expert"] = axis if expert_ok else None
    rules["pool_kv"] = axis if heads_ok else None
    fallbacks = []
    if cfg.family == "moe" and not expert_ok:
        fallbacks.append("expert")
    report = {
        "tp": tp,
        "parallel": parallel,
        "attention": "sharded" if heads_ok else "replicated",
        "experts": ("sharded" if expert_ok else "replicated")
        if cfg.family == "moe" else "n/a",
        "vocab": "replicated",
        "mlp": "replicated",
        "ssm": "replicated" if cfg.family in ("ssm", "hybrid") else "n/a",
        "attn_splits": 1,
    }
    if parallel == "efficient":
        vocab_ok = cfg.padded_vocab % tp == 0
        ff_dims = [cfg.d_ff]
        if cfg.family == "moe" and cfg.first_k_dense:
            ff_dims.append(cfg.dense_d_ff or cfg.d_ff)
        mlp_ok = all(d % tp == 0 for d in ff_dims)
        if heads_ok:
            rules["heads"] = rules["heads_out"] = rules["kv"] = axis
        else:
            fallbacks += ["heads", "heads_out", "kv"]
            # the pool stays replicated; attention parallelism comes from
            # an LSE split over the logical page axis instead
            report["attention"] = "lse-split" if tp > 1 else "replicated"
            report["attn_splits"] = tp
        rules["vocab"] = axis if vocab_ok else None
        rules["mlp"] = axis if mlp_ok else None
        if not vocab_ok:
            fallbacks.append("vocab")
        if not mlp_ok:
            fallbacks.append("mlp")
        report["vocab"] = "sharded" if vocab_ok else "replicated"
        report["mlp"] = "sharded" if mlp_ok else "replicated"
        if cfg.family in ("ssm", "hybrid"):
            d_inner = getattr(cfg, "d_inner", 0) or 0
            if d_inner and d_inner % tp == 0:
                rules["ssm_inner"] = axis
                report["ssm"] = "sharded"
            else:
                fallbacks.append("ssm_inner")
    report["fallbacks"] = tuple(fallbacks)
    return rules, report


def decode_rules(cfg, mesh, axis: str = "model", parallel: str = "exact"):
    """``decode_rule_table`` for an actual mesh (``launch.mesh.Mesh``):
    raises if any other mesh axis is bigger than 1 -- the serving engine
    manages the batch on the host and only shards over the model axis."""
    tp = mesh.shape[axis]
    for a in mesh.axis_names:
        if a != axis and mesh.shape[a] != 1:
            raise ValueError(
                f"decode_rules: non-'{axis}' mesh axis {a!r} has size "
                f"{mesh.shape[a]} — the serving engine manages the batch "
                "host-side and only shards over the model axis")
    return decode_rule_table(cfg, int(tp), axis, parallel)


def paged_kv_pool_spec(rules: dict) -> tuple:
    """Spec of the (L, n_pages, page, KV, dh) paged pool: pages shard over
    the kv-head dim (``"pool_kv"``, not the ``"kv"`` weight axis: under
    the exact rules wk/wv stay replicated while the pool they feed is
    sharded); the page grid and the host's block tables stay whole."""
    return (None, None, None, rules.get("pool_kv"), None)


def _is_spec(x) -> bool:
    return hasattr(x, "axes") and hasattr(x, "shape") \
        and hasattr(x, "dtype")


def _set(out: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        out = out.setdefault(key, {})
    out[path[-1]] = value


def resolve_specs(spec_tree, rules: dict):
    """Logical-axis tree (a template, or a tree of axes tuples) -> the same
    tree of per-dim mesh-axis tuples (``()`` for a replicated scalar)."""
    out: dict = {}
    for path, leaf in tree_items(spec_tree):
        axes = leaf.axes if _is_spec(leaf) else leaf
        _set(out, path, tuple(rules.get(a) for a in (axes or ())))
    return out


def pspec(*entries) -> tuple:
    """A spec tuple normalised as the reference's ``PartitionSpec``: a
    one-name tuple becomes the name, an empty one None."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            return None if not e else e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(norm(e) for e in entries)


def kv_cache_spec(cfg, mode: str, mesh,
                  global_batch: int | None = None) -> tuple:
    """Spec of a (layers, batch, seq, kv_heads, head_dim) cache: the batch
    over ``batch_axes``; the kv heads over 'model' when the config has at
    least ``model_parallel`` of them, else the sequence (the flash-decode
    LSE combine)."""
    b_ax = batch_axes(mesh, global_batch)
    if cfg.n_kv_heads >= cfg.model_parallel:
        return pspec(None, b_ax, None, "model", None)
    return pspec(None, b_ax, "model", None, None)


def ssm_state_spec(cfg, mode: str, mesh,
                   global_batch: int | None = None) -> dict:
    """Specs of the Mamba2 state {ssd: (L, B, H, P, N), conv: (L, B, K-1,
    DI)}: heads, and the conv tail's inner dim, over 'model'."""
    b_ax = batch_axes(mesh, global_batch)
    return {"ssd": pspec(None, b_ax, "model", None, None),
            "conv": pspec(None, b_ax, None, "model")}


def logits_spec(mesh, mode: str, global_batch: int | None = None) -> tuple:
    """Spec of (batch, vocab) logits: batch over ``batch_axes``, vocab over
    'model'."""
    return pspec(batch_axes(mesh, global_batch), "model")


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (the reference's ``NamedSharding``):
    ``spec`` names a mesh axis (or axes, or None) per dim, ``devices`` is
    the mesh's grid of devices."""

    mesh: object
    spec: tuple

    @property
    def devices(self):
        return self.mesh.devices

    def axis_size(self, entry) -> int:
        """Shards along a dim whose spec entry is ``entry``."""
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        return math.prod(self.mesh.shape[a] for a in names)

    def wide(self) -> list:
        """The spec's entries that cut a dim over more than one device."""
        return [e for e in self.spec if self.axis_size(e) > 1]


def named_shardings(mesh, spec_tree):
    """A tree of resolved specs (tuples; dicts of them) -> the same tree of
    ``NamedSharding`` on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named_shardings(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, tuple(spec_tree))


def _spec_str(spec: tuple) -> str:
    """A resolved spec printed as the reference prints its PartitionSpec."""
    return f"PartitionSpec{tuple(spec)!r}"


def shard_bytes_table(template, rules: dict, tp: int,
                      fallbacks=()) -> list[dict]:
    """Per-tensor byte accounting of a parameter template under a rule
    set: one row per ParamSpec with its global bytes, the bytes a device
    holds (``bytes // tp`` when any of its axes maps to a mesh axis, else
    the full size), and whether replication was a divisibility fallback
    (an axis in ``fallbacks``).  Rows and names as the reference's."""
    rows = []
    for path, spec in tree_items(template):
        axes = spec.axes if spec.axes is not None else ()
        sharded = any(rules.get(a) is not None for a in axes)
        nbytes = int(math.prod(spec.shape)) \
            * torch.empty((), dtype=spec.dtype).element_size()
        rows.append({
            "name": "".join(f"[{k!r}]" for k in path),
            "shape": tuple(int(d) for d in spec.shape),
            "axes": tuple(axes),
            "spec": _spec_str(tuple(rules.get(a) for a in axes)),
            "bytes": nbytes,
            "bytes_per_device": nbytes // tp if sharded else nbytes,
            "sharded": sharded,
            "fallback": not sharded and any(a in fallbacks for a in axes),
        })
    return rows
