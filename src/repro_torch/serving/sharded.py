"""Tensor-parallel serving: the sharding plan of one engine (the port of
``repro.serving.sharded``).

``ShardingPlan`` resolves ``sharding.partitioning.decode_rules`` for a
model on a ``launch.mesh.Mesh`` and holds the execution layout:

  * per-shard parameter trees: a leaf whose logical axis maps to the mesh
    is cut into ``tp`` equal slices along that dim, one per shard, on the
    shard's device; a replicated leaf is the same tensor on every shard
    of a device (shards that share a device share it, ``describe`` still
    counts it per shard, as the reference does);
  * per-shard KV pools: (L, n_pages, page, KV / tp, dh) slices of the
    paged pool when the kv heads divide, else the whole pool once per
    device.  The page grid and the host's block tables stay whole and
    shard-invariant, and swap payloads stay full-head host tensors,
    gathered on swap-out and cut again on swap-in;
  * the collectives, written out here: ``all_gather`` (concatenation on
    the plan's first device) and ``psum`` (a sum in a fixed order, shard 0
    first, in f32), moving tensors with ``.to(device)``, a no-op between
    shards of one card.

The reference executes the same rules through GSPMD (jit + named
shardings).  The port is single-controller too -- one host loop, one
scheduler, one KV manager, global logical shapes -- and runs the sharded
dataflow eagerly (``models.transformer``, under ``context()``): work on
replicated values runs once on the first device, sharded work once per
shard.

``parallel="exact"`` shards only the pool: attention runs per shard over
its kv heads and every GEMM keeps its unsharded shape, so the streams
are token-identical to one device.  ``parallel="efficient"`` adds the
Megatron axes: column-parallel wq/wk/wv and MLP up/gate, row-parallel
wo/down (one psum each), vocab-sharded embedding and logits (sampling
partitioned: only the winning token crosses shards), and, when the kv
heads do not divide, the LSE split of the logical page axis, one stripe
per shard.  It is held to the tolerance contract
(``testing.assert_tokens_close``).

Only the dense family runs sharded (``shards_model``); a 1x1 mesh serves
every family through the single-device path, and the engine refuses the
others at tp > 1.
"""

from __future__ import annotations

import math
import warnings as _warnings
from dataclasses import dataclass

import torch

from ..kernels.bucketing import pow2_bucket
from ..sharding.context import serving_sharding
from ..sharding.partitioning import (decode_rule_table, decode_rules,
                                     resolve_specs, shard_bytes_table)

__all__ = ["ShardingPlan", "estimate_device_bytes",
           "REPLICATION_WARN_BYTES"]

# describe() warns when a weight at least this big hit the replication
# fallback (its logical axis did not divide the mesh)
REPLICATION_WARN_BYTES = 32 << 20


@dataclass(frozen=True)
class ShardingPlan:
    mesh: object
    tp: int
    parallel: str                 # "exact" | "efficient"
    rules: dict
    report: dict
    specs: dict                   # per-leaf mesh-axis tuples
    devices: tuple                # the device of each shard
    n_heads: int
    n_kv_heads: int
    attn_splits: int              # LSE page stripes (1 = no split)
    shards_model: bool            # the dense family runs sharded
    tensor_rows: tuple            # per-tensor byte/spec accounting rows
    warnings: tuple               # big-weight replication-fallback notes

    @classmethod
    def build(cls, model, mesh, parallel: str = "exact") -> "ShardingPlan":
        """Resolve the serving-decode rules for ``model`` on ``mesh``
        (raises if the data axis is bigger than 1)."""
        cfg = model.cfg
        rules, report = decode_rules(cfg, mesh, parallel=parallel)
        tp = int(mesh.shape["model"])
        template = model.template()
        rows = tuple(shard_bytes_table(template, rules, tp,
                                       fallbacks=report["fallbacks"]))
        warns = tuple(
            f"{r['name']} ({r['bytes'] / 2**20:.0f} MiB, axes {r['axes']}) "
            "hit the replication fallback — its sharding axis does not "
            f"divide tp={tp}; every device holds a full copy"
            for r in rows
            if r["fallback"] and r["bytes"] >= REPLICATION_WARN_BYTES)
        for w in warns:
            _warnings.warn(w, RuntimeWarning, stacklevel=3)
        return cls(
            mesh=mesh, tp=tp, parallel=parallel, rules=rules,
            report=report, specs=resolve_specs(template, rules),
            devices=tuple(mesh.devices[0]), n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            attn_splits=int(report["attn_splits"])
            if parallel == "efficient" else 1,
            shards_model=cfg.family == "dense", tensor_rows=rows,
            warnings=warns)

    # ------------------------------------------------------------ layout

    @property
    def primary(self) -> torch.device:
        """Where replicated work runs and collectives land."""
        return self.devices[0]

    @property
    def heads_sharded(self) -> bool:
        """Column-parallel q/k/v and row-parallel wo (efficient mode)."""
        return self.rules.get("heads") is not None

    @property
    def pool_sharded(self) -> bool:
        return self.rules.get("pool_kv") is not None

    @property
    def mlp_sharded(self) -> bool:
        return self.rules.get("mlp") is not None

    @property
    def vocab_sharded(self) -> bool:
        return self.rules.get("vocab") is not None

    @property
    def pool_owners(self) -> list[int]:
        """The shards whose pool tensors are distinct: every shard when the
        pool is sharded, else the first shard on each device."""
        if self.pool_sharded:
            return list(range(self.tp))
        seen, out = set(), []
        for s, dev in enumerate(self.devices):
            if dev not in seen:
                seen.add(dev)
                out.append(s)
        return out

    def kv_slice(self, s: int) -> slice:
        """Shard s's kv heads within the full pool."""
        if not self.pool_sharded:
            return slice(None)
        n = self.n_kv_heads // self.tp
        return slice(s * n, (s + 1) * n)

    def split_heads(self, x, *, q_heads: bool) -> list:
        """Cut (..., heads, dh) into shard s's heads of the pool's kv-head
        sharding, each on its shard's device."""
        rep = self.n_heads // self.n_kv_heads if q_heads else 1
        out = []
        for s, dev in enumerate(self.devices):
            sl = self.kv_slice(s)
            start = (sl.start or 0) * rep
            width = x.shape[-2] if sl.stop is None \
                else (sl.stop - sl.start) * rep
            out.append(x.narrow(-2, start, width).to(dev))
        return out

    def place_params(self, params):
        """Per-shard parameter trees (the tree itself when the family does
        not run sharded)."""
        if not self.shards_model:
            return params
        return [self._place(params, self.specs, s, dev)
                for s, dev in enumerate(self.devices)]

    def _place(self, node, spec, s: int, dev):
        if isinstance(node, dict):
            return {k: self._place(v, spec[k], s, dev)
                    for k, v in node.items()}
        dim = next((i for i, a in enumerate(spec) if a is not None), None)
        if dim is None:
            return node.to(dev)
        n = node.shape[dim] // self.tp
        return node.narrow(dim, s * n, n).to(dev).contiguous()

    def place_cache(self, cache: dict):
        """Per-shard paged caches from the whole (L, n_pages, page, KV, dh)
        pools: kv-head slices when the pool is sharded, else the whole pool
        once per device.  The cache itself when the family does not run
        sharded."""
        if not self.shards_model:
            return cache
        out, copies = [], {}
        for s, dev in enumerate(self.devices):
            if self.pool_sharded:
                sl = self.kv_slice(s)
                out.append({k: cache[k][:, :, :, sl].to(dev).contiguous()
                            for k in ("k", "v")})
            else:
                if dev not in copies:
                    copies[dev] = {k: cache[k].to(dev) for k in ("k", "v")}
                out.append(dict(copies[dev]))
        return out

    # -------------------------------------------------------- collectives

    def all_gather(self, parts, dim: int):
        """Per-shard pieces concatenated along ``dim`` on the first device."""
        if len(parts) == 1:
            return parts[0].to(self.primary)
        return torch.cat([p.to(self.primary) for p in parts], dim=dim)

    def psum(self, parts):
        """Sum of per-shard partials on the first device, in shard order,
        accumulated in f32 and rounded once to the partials' dtype."""
        if len(parts) == 1:
            return parts[0].to(self.primary)
        acc = parts[0].to(self.primary, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(self.primary, torch.float32)
        return acc.to(parts[0].dtype)

    def context(self):
        """Install the serving hooks (``sharding.context``) around the
        engine's model calls."""
        return serving_sharding(self)

    # ------------------------------------------------- engine KV plumbing

    @staticmethod
    def _flat(pool):
        """(L, n_pages * page, KV, dh) view of a pool."""
        return pool.view((pool.shape[0], -1) + tuple(pool.shape[3:]))

    def gather_tokens(self, caches, idx):
        """Per-shard (past_k, past_v) lists of (L, 1, n, KV_s, dh) at flat
        token indices ``idx``; one gather shared by every shard where the
        pool is replicated (the prefill's attention then runs on the first
        device)."""
        ks, vs = [], []
        for s, c in enumerate(caches):
            if s and not self.pool_sharded:
                ks.append(ks[0])
                vs.append(vs[0])
                continue
            i = idx.to(c["k"].device)
            ks.append(self._flat(c["k"])[:, i][:, None])
            vs.append(self._flat(c["v"])[:, i][:, None])
        return ks, vs

    def write_tokens(self, caches, ks, vs, idx) -> None:
        """Write full-head (L, 1, n, KV, dh) K/V at flat token indices
        ``idx``: each distinct pool takes its kv-head slice, in place."""
        for s in self.pool_owners:
            c, sl = caches[s], self.kv_slice(s)
            dev = c["k"].device
            i = idx.to(dev)
            for name, x in (("k", ks), ("v", vs)):
                f = self._flat(c[name])
                f[:, i] = x[:, 0, :, sl].to(dev, f.dtype)

    def gather_blocks(self, caches, idx):
        """Full-head (L, n, page, KV, dh) host copies of pool blocks
        ``idx`` (a swap-out payload): the shards' slices concatenated over
        the kv heads."""
        owners = self.pool_owners if self.pool_sharded else [0]
        out = []
        for name in ("k", "v"):
            parts = [caches[s][name][:, idx.to(caches[s][name].device)]
                     .cpu() for s in owners]
            out.append(torch.cat(parts, dim=3) if len(parts) > 1
                       else parts[0])
        return out[0], out[1]

    def write_blocks(self, caches, idx, k, v) -> None:
        """Scatter full-head host blocks back into every pool (swap-in)."""
        for s in self.pool_owners:
            c, sl = caches[s], self.kv_slice(s)
            dev = c["k"].device
            i = idx.to(dev)
            c["k"][:, i] = k[:, :, :, sl].to(dev)
            c["v"][:, i] = v[:, :, :, sl].to(dev)

    # ------------------------------------------------------------ reporting

    def describe(self) -> dict:
        """What actually sharded (per component) on this mesh -- the
        divisibility fallbacks make this the source of truth, not the
        requested tp -- with the per-tensor rows, the bytes every device
        pays again (``replicated_bytes``) and any big-weight
        replication-fallback warnings."""
        rows = [dict(r) for r in self.tensor_rows]
        return {
            "devices": self.mesh.size, "tp": self.tp, **self.report,
            "tensors": rows,
            "param_bytes": sum(r["bytes"] for r in rows),
            "param_bytes_per_device":
                sum(r["bytes_per_device"] for r in rows),
            "replicated_bytes":
                sum(r["bytes"] for r in rows if not r["sharded"]),
            "warnings": list(self.warnings),
        }


# ------------------------------------------------------ memory preflight

def _nested_bytes(node) -> int:
    """Bytes of a nested {name: (shape, dtype)} tree."""
    if isinstance(node, dict):
        return sum(_nested_bytes(v) for v in node.values())
    shape, dtype = node
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def estimate_device_bytes(model, *, tp: int, parallel: str = "exact",
                          n_pages: int, page_size: int,
                          n_slots: int) -> dict:
    """Per-device byte budget for serving ``model`` at width ``tp``:
    weights shard + paged-KV-pool shard + fused-step workspace, by pure
    arithmetic over the template and the mesh-free rule table (no device
    is touched), as the reference computes it.  The workspace is a
    deliberate over-estimate: two f32 logits-sized buffers at the largest
    lane bucket plus one f32 MLP hidden buffer, each divided by tp where
    its GEMM is sharded."""
    cfg = model.cfg
    rules, report = decode_rule_table(cfg, tp, parallel=parallel)
    rows = shard_bytes_table(model.template(), rules, tp,
                             fallbacks=report["fallbacks"])
    weights = sum(r["bytes_per_device"] for r in rows)
    pool_div = tp if rules.get("pool_kv") else 1
    kv_pool = 0
    for key, val in model.paged_cache_shapes(n_pages, page_size,
                                             n_slots).items():
        nbytes = _nested_bytes(val)
        kv_pool += nbytes // pool_div if key in ("k", "v") else nbytes
    nb = pow2_bucket(n_slots, floor=8, cap=max(n_slots, 1))
    vocab_div = tp if rules.get("vocab") else 1
    mlp_div = tp if rules.get("mlp") else 1
    workspace = 2 * nb * cfg.padded_vocab * 4 // vocab_div \
        + nb * max(cfg.d_ff // mlp_div, cfg.d_model) * 4
    return {
        "tp": tp,
        "parallel": parallel,
        "weights_bytes": int(weights),
        "kv_pool_bytes": int(kv_pool),
        "workspace_bytes": int(workspace),
        "total_bytes": int(weights + kv_pool + workspace),
        "replicated_bytes": int(sum(r["bytes"] for r in rows
                                    if not r["sharded"])),
        "report": report,
    }
