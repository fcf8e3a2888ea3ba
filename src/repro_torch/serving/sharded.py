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

``parallel="exact"`` shards only the pool and the MoE experts: attention
runs per shard over its kv heads, each shard runs its E / tp experts on
its slice of the capacity buffer, and every GEMM keeps its unsharded
shape, so the streams are token-identical to one device.  ``parallel="efficient"`` adds the
Megatron axes: column-parallel wq/wk/wv and MLP up/gate, row-parallel
wo/down (one psum each; the MoE shared experts and an MoE model's
leading dense blocks are MLPs too), vocab-sharded embedding and logits
(sampling
partitioned: only the winning token crosses shards), and, when the kv
heads do not divide, the LSE split of the logical page axis, one stripe
per shard.  It is held to the tolerance contract
(``testing.assert_tokens_close``).

The recurrent families (SSM, hybrid) follow the same rules.  Under the
exact plan every Mamba2 parameter and the per-slot recurrent state are
replicated (the reference's ``constrain_cache``: "recurrent state
replicated") and the Mamba2 layers run once on the first device; only the
hybrid's attention pool shards over kv heads.  The efficient plan shards
``ssm_inner``: in_proj_x, in_proj_z and conv_w column-parallel (shard s
holds heads [s H/tp, (s+1) H/tp) and their conv channels, and the slot
state of those heads), bc_proj, dt_proj, dt_bias, a_log and d_skip
replicated and computed once, out_proj row-parallel with one psum.  Swap
payloads stay full-head host copies of the state, gathered from the
shards and cut again.

Every decoder family runs sharded (``shards_model``); the encoder-decoder
is not served.
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
from ..tree import tree_leaves

__all__ = ["ShardingPlan", "estimate_device_bytes",
           "REPLICATION_WARN_BYTES"]

# describe() warns when a weight at least this big hit the replication
# fallback (its logical axis did not divide the mesh)
REPLICATION_WARN_BYTES = 32 << 20
# the dim that holds the Mamba2 heads of each recurrent-state tensor: the
# ssd state (..., H, P, N), the conv tail (..., H * P)
_SSM_HEAD_DIM = {"ssd": -3, "conv": -1}


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
    ssm_heads: int                # Mamba2 heads (0 for no SSM)
    attn_splits: int              # LSE page stripes (1 = no split)
    shards_model: bool            # a decoder family: runs sharded
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
            ssm_heads=cfg.ssm_heads if cfg.family in ("ssm", "hybrid")
            else 0,
            attn_splits=int(report["attn_splits"])
            if parallel == "efficient" else 1,
            shards_model=cfg.family in ("dense", "moe", "vlm", "ssm",
                                        "hybrid"),
            tensor_rows=rows,
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
    def experts_sharded(self) -> bool:
        """Expert parallelism: shard s holds experts [s E/tp, (s+1) E/tp)."""
        return self.rules.get("expert") is not None

    @property
    def vocab_sharded(self) -> bool:
        return self.rules.get("vocab") is not None

    @property
    def ssm_sharded(self) -> bool:
        """Column-parallel Mamba2 heads (efficient mode, d_inner dividing
        tp): shard s holds heads [s H/tp, (s+1) H/tp)."""
        return self.rules.get("ssm_inner") is not None

    def ssm_slice(self, s: int) -> slice:
        """Shard s's Mamba2 heads (all of them where the SSM does not
        shard); its conv channels are the same slice of the heads' P-wide
        groups (``_ssm_cut``)."""
        if not self.ssm_sharded:
            return slice(None)
        n = self.ssm_heads // self.tp
        return slice(s * n, (s + 1) * n)

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

    def split_experts(self, x) -> list:
        """Cut (E, ...) into shard s's experts, each on its shard's device;
        ``[x]`` where the experts do not shard."""
        if not self.experts_sharded:
            return [x]
        n = x.shape[0] // self.tp
        return [x[s * n:(s + 1) * n].to(dev)
                for s, dev in enumerate(self.devices)]

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
        once per device; and the per-slot recurrent state (``"ssm"``):
        each shard's heads when the SSM shards, else the whole state once,
        on the first device, shared by every shard's entry.  The cache
        itself when the family does not run sharded."""
        if not self.shards_model:
            return cache
        out, copies = [], {}
        for s, dev in enumerate(self.devices):
            c = {}
            if "k" in cache and self.pool_sharded:
                sl = self.kv_slice(s)
                c.update({k: cache[k][:, :, :, sl].to(dev).contiguous()
                          for k in ("k", "v")})
            elif "k" in cache:
                if dev not in copies:
                    copies[dev] = {k: cache[k].to(dev) for k in ("k", "v")}
                c.update(copies[dev])
            if "ssm" in cache:
                if self.ssm_sharded:
                    c["ssm"] = {name: self._ssm_cut(name, t, s).to(dev)
                                .contiguous()
                                for name, t in cache["ssm"].items()}
                else:
                    c["ssm"] = out[0]["ssm"] if out else {
                        name: t.to(self.primary)
                        for name, t in cache["ssm"].items()}
            out.append(c)
        return out

    @property
    def ssm_owners(self):
        """The shards whose recurrent states are distinct."""
        return range(self.tp) if self.ssm_sharded else [0]

    def _ssm_cut(self, name: str, t, s: int):
        """Shard s's part of a recurrent-state tensor: its heads of the
        ssd state (..., H, P, N), its channels of the conv tail (..., DI),
        P a head."""
        sl = self.ssm_slice(s)
        if sl.stop is None:
            return t
        dim = _SSM_HEAD_DIM[name]
        width = t.shape[dim] // self.ssm_heads
        return t.narrow(dim, sl.start * width, (sl.stop - sl.start) * width)

    def gather_state(self, caches, slot: int) -> dict:
        """A full-head host copy (never a view) of one slot's recurrent
        state: {"ssd": (L, H, P, N), "conv": (L, K-1, DI)}, the shards'
        heads concatenated when the SSM shards."""
        out = {}
        for name, dim in _SSM_HEAD_DIM.items():
            parts = [caches[s]["ssm"][name][:, slot].to("cpu", copy=True)
                     for s in self.ssm_owners]
            out[name] = torch.cat(parts, dim=dim) if len(parts) > 1 \
                else parts[0]
        return out

    def write_state(self, caches, slot: int, state: dict) -> None:
        """Write a full-head slot state ({"ssd": (L, H, P, N), "conv": (L,
        K-1, DI)}, on any device) into every shard's state, in place, each
        shard taking its heads.  ``slot`` is an int or a 0-dim index
        tensor (the engine's prefill graphs take it as an input)."""
        for s in self.ssm_owners:
            for name, t in caches[s]["ssm"].items():
                t.index_copy_(
                    1, torch.as_tensor(slot, device=t.device).view(1),
                    self._ssm_cut(name, state[name], s).to(
                        t.device, t.dtype).unsqueeze(1))

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
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for shape, dtype in tree_leaves(node))


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
