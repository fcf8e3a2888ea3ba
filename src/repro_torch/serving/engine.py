"""Continuous-batching serving engine driving the port's model on a card.

The port of ``repro.serving.engine``: the same vLLM-style iteration loop,
scheduled by ``repro_torch.core.Scheduler`` (SageSched or any baseline
policy), with the same host bookkeeping (``KVCacheManager`` block budget,
hysteresis, swap / recompute preemption, capacity-forced eviction,
Sarathi chunk budget) and the same pow2 ladders for every shape the
device sees.

    submit() -> scheduler.admit (predict + cost + Gittins)
    each step():
        1. select the running set under the block budget and slot limit;
        2. preempt displaced requests (swap: gather their KV blocks to a
           host tensor; recompute: drop them);
        3. admit newcomers (swap-ins scatter their saved blocks and
           recurrent state back; others prefill, in chunks through
           ``Model.prefill_chunk`` for the dense family, whole and padded
           to a pow2 bucket through ``Model.prefill`` for the recurrent
           SSM and hybrid families);
        4. relieve capacity pressure by forced eviction;
        5. decode every ready slot through the paged pool;
        6. sample and feed completions back to the scheduler.

``step_mode="fused"`` (default) runs stages 5-6 as one device step over
``decode_steps`` tokens: argmax (or Gumbel-max) sampling and the per-lane
length / EOS bookkeeping stay on the device, and the host gets one
(tokens, emitted, finished) transfer per call.
``step_mode="orchestrated"`` ships logits to the host every token and
samples with numpy, as the reference's parity oracle does.

On the card both decode steps run as CUDA graphs (``serving.step_graphs``),
as the reference runs them as jitted XLA programs: one graph per shape key,
(lane bucket, table bucket, ``decode_steps``, all-greedy) for the fused
step and (``n_slots``, pages a slot) for the orchestrated one, each
captured after its key's first, eager call.  ``fused_compile_count`` counts
the fused keys and ``max_fused_compiles()`` bounds them, as the
reference's jit cache.  ``graphs=False`` runs the same steps eagerly, the
counterpart of the reference under ``jax.disable_jit()``; on a CPU device
there are no graphs.  Prefill, swaps, ``Model.decode_step`` and the
scheduler's Gittins refresh stay outside the graphs.

KV memory is a paged pool: (L, n_pages, page, KV, dh) bf16 tensors shared
by the batch (G group layers for the hybrid), a per-slot block table
mapping logical positions to physical pages (page 0 = scratch, where
masked lanes write), and host tensors holding preempted requests' KV.
Recurrent state (``cache["ssm"]``) is per slot, so the fused lanes of the
recurrent families are slot-positional (lane = slot) and the state of an
inactive lane is frozen exactly.  The pool and the state are updated in
place.

Tensor-parallel serving (``mesh`` or ``tp``, ``parallel="exact" |
"efficient"``): the engine builds a ``serving.sharded.ShardingPlan``,
keeps per-shard weights and KV pools, runs its model calls under the
plan's hooks, gathers swap payloads to full-head host tensors and cuts
them again on swap-in, and samples vocab-sharded logits partitioned (only
the winning token crosses shards).  The host loop, the scheduler, the KV
manager and its block tables stay single and shard-invariant.  Only the
dense family runs sharded; a 1x1 mesh serves every family.
``device_memory_gb`` refuses, before anything is allocated, an engine
whose per-device weights, pool and workspace exceed it.

Not ported yet, and refused rather than ignored: tp > 1 for the SSM and
hybrid families (ROADMAP Queue A 16), prefix sharing (Queue A 5) and CUDA
graphs over a plan whose shards sit on more than one card (Queue A 15).
"""

from __future__ import annotations

import contextlib
import time
import zlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.scheduler import Scheduler
from ..kernels.bucketing import ladder_size as _ladder_size
from ..kernels.bucketing import pow2_bucket as _pow2_bucket
from ..models import Model
from ..simulator.service_model import ServiceModel
from .kv_cache import SCRATCH_BLOCK, KVCacheManager
from .metrics import EngineMetrics
from .request import RequestState, ServeRequest
from .sharded import ShardingPlan, estimate_device_bytes
from .step_graphs import StepGraphs, StepRunner

__all__ = ["ServingEngine", "EngineStallError"]

_MASK32 = 0xFFFFFFFF


class EngineStallError(RuntimeError):
    """``run_until_done`` exhausted its step budget with work still live.

    The message carries the full stall diagnosis (per-state request
    counts, queue depth, block-pool occupancy, pressure set)."""


def _pad_len(n: int, quantum: int = 64) -> int:
    """pow2 bucket with a floor — prefill chunk/prefix padding ladder."""
    return _pow2_bucket(n, floor=quantum)


def _rid_seed(request_id: str) -> int:
    """Stable per-request RNG seed: sampling draws depend on (request,
    position), never on slot assignment or preemption history, so swap
    and recompute schedules sample identical streams."""
    return zlib.crc32(request_id.encode())


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2**32
    (every product stays below 2**63, so no signed overflow)."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, rid_seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int, offset: int = 0) -> torch.Tensor:
    """(lanes, vocab) f32 Gumbel noise from a counter-based hash of
    (engine seed, request seed, position, token id) for the token ids
    offset .. offset + vocab - 1: plain integer torch ops, so the CPU and
    the card draw the same numbers, a lane's draw does not depend on its
    slot, and a vocab shard draws exactly its columns of the whole row."""
    dev = rid_seeds.device
    key = _mix32(_mix32(rid_seeds.long() ^ (seed & _MASK32))
                 ^ positions.long())
    col = _mix32(torch.arange(offset, offset + vocab, device=dev,
                              dtype=torch.int64) + 0x632BE5AB)
    h = _mix32(key[:, None] ^ col[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))     # (0, 1)
    return -torch.log(-torch.log(u))


@dataclass
class ServingEngine:
    model: Model
    scheduler: Scheduler
    n_slots: int = 8
    max_seq_len: int = 512
    capacity_tokens: int | None = None
    preemption_hysteresis: float = 0.5
    seed: int = 0
    params: dict | None = None
    block_size: int = 16                   # KV page size, tokens
    preemption_mode: str = "swap"          # "swap" | "recompute"
    prefill_chunk: int | None = None       # tokens per chunk; None = whole
    max_tokens_per_step: int | None = None  # mixed prefill+decode budget
    memory_weight: float = 0.5             # eviction memory term (0 = off)
    swap_capacity_tokens: int | None = None
    service_model: ServiceModel | None = None
    step_mode: str = "fused"               # "fused" | "orchestrated"
    decode_steps: int = 1                  # decode tokens per host round-trip
    prefix_sharing: bool = False
    clock: Callable[[], float] = time.monotonic
    mesh: object | None = None
    tp: int = 1
    parallel: str = "exact"
    device_memory_gb: float | None = None
    device: str | torch.device = "cuda"
    graphs: bool = True                    # decode steps as CUDA graphs

    _requests: dict[str, ServeRequest] = field(default_factory=dict)
    _running: list[str] = field(default_factory=list)

    def __post_init__(self):
        if self.preemption_mode not in ("swap", "recompute"):
            raise ValueError(f"bad preemption_mode {self.preemption_mode!r}")
        if self.step_mode not in ("fused", "orchestrated"):
            raise ValueError(f"bad step_mode {self.step_mode!r}")
        if self.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if not self.model.supports_paged:
            raise ValueError(
                f"{self.model.cfg.family} models are not servable through "
                "the paged engine")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.parallel not in ("exact", "efficient"):
            raise ValueError(
                f"bad parallel {self.parallel!r}: expected 'exact' or "
                "'efficient'")
        if self.prefix_sharing:
            raise NotImplementedError(
                "prefix sharing is not ported yet: ROADMAP Queue A 5")
        self.device = torch.device(self.device)
        self.plan = None
        if self.mesh is None and self.tp > 1:
            from ..launch.mesh import make_local_mesh
            # tp cards; on the CPU the caller asked for, tp CPU shards
            self.mesh = make_local_mesh(
                tp=self.tp, devices=None if self.device.type == "cuda"
                else [self.device] * self.tp)
        if self.mesh is not None:
            self.plan = ShardingPlan.build(self.model, self.mesh,
                                           parallel=self.parallel)
            if self.tp > 1 and self.tp != self.plan.tp:
                raise ValueError(
                    f"tp={self.tp} contradicts mesh model axis "
                    f"{self.plan.tp}")
            self.tp = self.plan.tp
            self.device = self.plan.primary
            if self.graphs and len(set(self.plan.devices)) > 1:
                raise NotImplementedError(
                    "CUDA graphs over a plan whose shards sit on "
                    f"{len(set(self.plan.devices))} devices: one graph "
                    "cannot span cards, and multi-card serving is ROADMAP "
                    "Queue A 15; pass graphs=False")
            if self.tp > 1 and not self.plan.shards_model:
                raise NotImplementedError(
                    f"tensor-parallel serving of the {self.model.cfg.family} "
                    "family (tp > 1) is not ported yet: ROADMAP Queue A 16")
        # the dense family under a plan keeps per-shard weights and pools
        self._sharded = self.plan is not None and self.plan.shards_model
        # KVCacheManager is host bookkeeping: built before the preflight
        # so pool_blocks feeds the estimate before anything is allocated
        self.kv = KVCacheManager(
            self.n_slots, self.max_seq_len, self.capacity_tokens,
            block_size=self.block_size,
            swap_capacity_tokens=self.swap_capacity_tokens)
        self._preflight_memory()
        if self.params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = self.model.init(gen)
        compute_dtype = self.params["embed"].dtype
        if self.plan is not None:
            self.params = self.plan.place_params(self.params)
        if self.service_model is None:
            self.service_model = ServiceModel()
        self.metrics = EngineMetrics()
        self._rng = np.random.default_rng(self.seed)
        self._cache = self.model.init_paged_cache(
            self.kv.pool_blocks, self.block_size, self.n_slots,
            device=self.device, conv_dtype=compute_dtype)
        self._has_kv = "k" in self._cache
        # recurrent families carry per-slot state inside the cache: their
        # fused lanes are slot-positional (a single lane bucket)
        self._slot_state = "ssm" in self._cache
        if self.plan is not None:
            # pool pages live per shard from here on (kv-head slices); the
            # host block tables stay authoritative and shard-agnostic
            self._cache = self.plan.place_cache(self._cache)
        self._max_pages = -(-self.max_seq_len // self.block_size)
        self._block_tables = np.full((self.n_slots, self._max_pages),
                                     SCRATCH_BLOCK, np.int32)
        # cache_len < 0 marks a slot that is not decode-ready (free, or
        # still prefilling); the decode step masks it to 0
        self._cache_len = np.full(self.n_slots, -1, np.int64)
        self._last_token = np.zeros(self.n_slots, np.int64)
        self._slot_rid: dict[int, str] = {}
        self._needs_grow: set[str] = set()
        # one runner per shape key; their graphs share one memory pool
        self._step_graphs = StepGraphs(self.device, self.graphs)
        self._fused_runners: dict[tuple, StepRunner] = {}
        self._orchestrated_runner: StepRunner | None = None

    def _preflight_memory(self) -> None:
        """Refuse to build an engine that cannot fit one shard on one
        device: pure arithmetic over the parameter template and the pool
        shapes (``sharded.estimate_device_bytes``), before any device
        allocation, so an over-budget config fails with a breakdown
        instead of an allocator error mid-init."""
        self.preflight = None
        if self.device_memory_gb is None:
            return
        est = estimate_device_bytes(
            self.model, tp=self.tp, parallel=self.parallel,
            n_pages=self.kv.pool_blocks, page_size=self.block_size,
            n_slots=self.n_slots)
        budget = int(self.device_memory_gb * (1 << 30))
        if est["total_bytes"] > budget:
            gib = 1 << 30
            fixes = "raise tp or shrink the KV pool" \
                if self.parallel == "efficient" \
                else "raise tp, switch parallel='efficient', or shrink " \
                     "the KV pool"
            raise ValueError(
                f"model {self.model.cfg.name!r} does not fit: per-device "
                f"need {est['total_bytes'] / gib:.2f} GiB "
                f"(weights {est['weights_bytes'] / gib:.2f} + "
                f"KV pool {est['kv_pool_bytes'] / gib:.2f} + "
                f"workspace {est['workspace_bytes'] / gib:.2f}) "
                f"> budget {self.device_memory_gb:.2f} GiB at "
                f"tp={self.tp} parallel={self.parallel!r}; {fixes} "
                f"(replicated bytes: {est['replicated_bytes'] / gib:.2f} "
                "GiB)")
        self.preflight = est

    # ---------------------------------------------------------- device ops

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _ctx(self):
        """The plan's serving hooks around a model call (nothing on one
        device)."""
        return self.plan.context() if self.plan is not None \
            else contextlib.nullcontext()

    def _flat_pools(self):
        """(L, n_pages * page, KV, dh) views of the K and V pools."""
        k, v = self._cache["k"], self._cache["v"]
        shape = (k.shape[0], -1) + tuple(k.shape[3:])
        return k.view(shape), v.view(shape)

    def _gather(self, idx: torch.Tensor):
        """(L, 1, n, KV, dh) K and V at flat pool indices (per-shard lists
        under a plan)."""
        if self._sharded:
            return self.plan.gather_tokens(self._cache, idx)
        fk, fv = self._flat_pools()
        return fk[:, idx][:, None], fv[:, idx][:, None]

    def _scatter(self, ks, vs, idx: torch.Tensor) -> None:
        # in place: the chunk's KV is written straight into the pool
        if self._sharded:
            self.plan.write_tokens(self._cache, ks, vs, idx)
            return
        fk, fv = self._flat_pools()
        fk[:, idx] = ks[:, 0].to(fk.dtype)
        fv[:, idx] = vs[:, 0].to(fv.dtype)

    # ------------------------------------------------------------ frontend

    def submit(self, request: ServeRequest) -> None:
        """Enqueue one request — the B = 1 case of ``submit_batch``."""
        self.submit_batch([request])

    def submit_batch(self, requests: list[ServeRequest],
                     length_dists: list | None = None) -> None:
        """Enqueue a burst of requests through one batched admission.
        Unstamped arrivals (``arrival == 0.0``) share one clock reading."""
        if not requests:
            return
        now = self.clock()
        arrivals = [now if r.arrival == 0.0 else r.arrival
                    for r in requests]
        # admit first: admit_batch rejects duplicates before mutating any
        # state, so a failed burst leaves no ghost entries in _requests
        self.scheduler.admit_batch(
            [r.request_id for r in requests],
            [r.prompt for r in requests],
            [r.input_len for r in requests],
            arrivals=arrivals, length_dists=length_dists,
            tenants=[r.tenant for r in requests])
        for r, arrival in zip(requests, arrivals):
            r.arrival = arrival
            self._requests[r.request_id] = r

    def abort(self, request_id: str, reason: str = "abort") -> None:
        """Terminate a request in any non-terminal state, releasing its
        device blocks, slot and host swap payload."""
        r = self._requests.get(request_id)
        if r and not r.done:
            self._release(r)
            r.state = RequestState.ABORTED
            r.finish_reason = reason
            self.metrics.aborted += 1
            self.metrics.wasted_tokens += r.generated
            if reason.endswith("_deadline"):
                self.metrics.timeout_aborts += 1
            self.scheduler.on_abort(request_id)

    @property
    def has_work(self) -> bool:
        return any(not r.done for r in self._requests.values())

    # -------------------------------------------------------- slot plumbing

    def _clear_slot(self, r: ServeRequest) -> None:
        if r.slot >= 0:
            self._slot_rid.pop(r.slot, None)
            self._cache_len[r.slot] = -1
            self._block_tables[r.slot] = SCRATCH_BLOCK
            r.slot = -1
        if r.request_id in self._running:
            self._running.remove(r.request_id)
        self._needs_grow.discard(r.request_id)

    def _release(self, r: ServeRequest) -> None:
        """Drop every engine-side resource (completion / abort)."""
        if self.kv.holds(r.request_id):
            self.kv.release(r.request_id)
        self.kv.drop_swapped(r.request_id)
        r.prefill_pos = 0
        self._clear_slot(r)

    def _bind_slot(self, r: ServeRequest, slot: int) -> None:
        r.slot = slot
        self._slot_rid[slot] = r.request_id
        row = np.full(self._max_pages, SCRATCH_BLOCK, np.int32)
        blocks = self.kv.block_table(r.request_id)
        row[:len(blocks)] = blocks
        self._block_tables[slot] = row
        if r.request_id not in self._running:
            self._running.append(r.request_id)
        r.state = RequestState.RUNNING

    def _sync_block_table(self, r: ServeRequest) -> None:
        """Refresh a slot's table row after ``grow`` appended blocks."""
        blocks = self.kv.block_table(r.request_id)
        self._block_tables[r.slot, :len(blocks)] = blocks

    # ------------------------------------------------------------ swap plane

    def _gather_payload(self, r: ServeRequest, blocks: list[int]) -> dict:
        slot = r.slot
        payload = {
            "cache_len": int(self._cache_len[slot]),
            "last_token": int(self._last_token[slot]),
            "prefill_pos": r.prefill_pos,
        }
        if self._has_kv:
            idx = self._to_dev(np.asarray(blocks, np.int64))
            if self._sharded:
                # full-head host payload: the shards' slices gathered
                payload["k"], payload["v"] = self.plan.gather_blocks(
                    self._cache, idx)
            else:
                payload["k"] = self._cache["k"][:, idx].cpu()
                payload["v"] = self._cache["v"][:, idx].cpu()
        if self._slot_state:
            # a copy even on the CPU, where .cpu() would return a view of
            # the live state that the next decode step overwrites
            payload["ssm"] = {name: t[:, slot].to("cpu", copy=True)
                              for name, t in self._cache["ssm"].items()}
        return payload

    def _restore_payload(self, r: ServeRequest, payload: dict) -> None:
        slot = r.slot
        blocks = self.kv.block_table(r.request_id)
        skip = self.kv.adopted_blocks_of(r.request_id)
        if self._has_kv and len(blocks) > skip:
            idx = self._to_dev(np.asarray(blocks[skip:], np.int64))
            # in place: the saved pages go straight back into the pool
            if self._sharded:
                self.plan.write_blocks(self._cache, idx,
                                       payload["k"][:, skip:],
                                       payload["v"][:, skip:])
            else:
                self._cache["k"][:, idx] = \
                    payload["k"][:, skip:].to(self.device)
                self._cache["v"][:, idx] = \
                    payload["v"][:, skip:].to(self.device)
        if self._slot_state:
            for name, t in self._cache["ssm"].items():
                t[:, slot] = payload["ssm"][name].to(self.device)
        self._cache_len[slot] = payload["cache_len"]
        self._last_token[slot] = payload["last_token"]
        r.prefill_pos = payload["prefill_pos"]

    def _preempt(self, r: ServeRequest) -> None:
        rid = r.request_id
        swapped = False
        if (self.preemption_mode == "swap" and self.kv.holds(rid)
                and self.kv.can_swap_out(rid)):
            blocks = self.kv.block_table(rid)
            payload = self._gather_payload(r, blocks)
            tokens = self.kv.swap_out(rid, payload)
            self.metrics.swap_outs += 1
            self.metrics.swapped_out_tokens += tokens
            self.metrics.modeled_swap_s += self.service_model.swap_time(
                tokens, self.kv.block_size)
            swapped = True
        elif self.kv.holds(rid):
            self.kv.release(rid)
        if not swapped:
            r.prefill_pos = 0      # recompute mode: replay the context
        self._clear_slot(r)
        r.state = RequestState.SWAPPED
        r.n_preemptions += 1
        self.metrics.preemptions += 1

    # --------------------------------------------------------------- select

    def _select_running(self) -> list[str]:
        """Scheduler-priority admission under the slot limit and the
        KVCacheManager's block budget (the accessor ``can_admit`` uses)."""
        live = [rid for rid, r in self._requests.items() if not r.done]
        if not live:
            return []
        running = set(self._running)
        if self.scheduler.preemptive:
            order = self.scheduler.order(
                live, running=running,
                hysteresis=self.preemption_hysteresis)
        else:
            order = self.scheduler.order(live, running=running,
                                         pin_running=True)
        selected, used_blocks = [], 0.0
        budget = self.kv.budget_blocks
        for rid in order:
            if len(selected) >= self.n_slots:
                break
            need = float(self.kv.blocks_for(
                self._requests[rid].context_len + 1))
            if self.kv.holds(rid):
                need -= self.kv.shared_excess_blocks(rid)
            if used_blocks + need <= budget:
                selected.append(rid)
                used_blocks += need
        if not selected:
            # nothing fits (e.g. one giant prompt): force the top request
            # so the engine cannot stall; if its context exceeds even the
            # physical pool, step()'s admit guard rejects it outright
            selected = [order[0]]
        return selected

    # --------------------------------------------------------------- admit

    def _admit(self, r: ServeRequest) -> None:
        rid = r.request_id
        if self.preemption_mode == "swap" and self.kv.is_swapped(rid):
            try:
                slot, payload = self.kv.swap_in(rid)
            except RuntimeError:
                # capacity shortfalls resolve next step (re-raise); a
                # failure while the pool HAD room is a faulty payload:
                # drop the host copy and recompute instead of livelocking
                need = self.kv.blocks_for(self.kv.swapped_tokens_of(rid))
                if self.kv.free_slots == 0 or need > self.kv.free_blocks:
                    raise
                self.metrics.swap_in_faults += 1
                self.kv.drop_swapped(rid)
                r.prefill_pos = 0
            else:
                self._restore_swapped(r, slot, payload)
                return
        self.kv.drop_swapped(rid)
        slot = self.kv.allocate(rid, r.context_len)  # prompt + outputs
        r.prefill_pos = 0
        self._bind_slot(r, slot)
        self._cache_len[slot] = -1   # not decode-ready until prefilled

    def _restore_swapped(self, r: ServeRequest, slot: int,
                         payload: dict) -> None:
        rid = r.request_id
        tokens = self.kv.tokens_of(rid)
        r.slot = slot
        self._bind_slot(r, slot)
        self._restore_payload(r, payload)
        r.n_swap_restores += 1
        self.metrics.swap_ins += 1
        self.metrics.swapped_in_tokens += tokens
        self.metrics.modeled_swap_s += self.service_model.swap_time(
            tokens, self.kv.block_size)
        # a request preempted while awaiting a growth block comes back one
        # block short of its next write position: re-grow (or re-mark the
        # pressure) before it may decode again
        if self._cache_len[slot] >= 0 \
                and self.kv.tokens_of(rid) <= self._cache_len[slot]:
            if self.kv.grow(rid, 1):
                self._sync_block_table(r)
            else:
                self.metrics.grow_failures += 1
                self._needs_grow.add(rid)

    # -------------------------------------------------------------- prefill

    def _phys_positions(self, r: ServeRequest, lo: int, hi: int,
                        pad_to: int) -> np.ndarray:
        """Flat pool token indices for logical positions [lo, hi), padded
        to ``pad_to`` entries pointing at the scratch page."""
        page = self.block_size
        table = self._block_tables[r.slot]
        pos = np.arange(lo, lo + pad_to)
        phys = table[np.minimum(pos // page, self._max_pages - 1)] * page \
            + pos % page
        phys[pos >= hi] = SCRATCH_BLOCK * page
        return phys.astype(np.int64)

    def _finalize_prefill(self, r: ServeRequest, ctx: list[int]) -> None:
        # the prefill ran over a padded buffer, so rewind one position and
        # let the shared decode path re-emit from the true last context
        # token (the cache holds positions < len(ctx))
        self._cache_len[r.slot] = len(ctx) - 1
        self._last_token[r.slot] = ctx[-1]
        self.metrics.prefills += 1

    def _prefill_chunk_step(self, r: ServeRequest, take: int) -> None:
        """Advance one Sarathi chunk: run [prefill_pos, prefill_pos+take)
        against the pool-resident prefix, scatter the chunk's KV."""
        ctx = r.prompt_tokens + r.output_tokens
        s0, s1 = r.prefill_pos, r.prefill_pos + take
        cpad = _pad_len(take)
        toks = np.zeros((1, cpad), np.int64)
        toks[0, :take] = ctx[s0:s1]
        # no prefix yet: an empty gather, (L, 1, 0, KV, dh)
        idx = self._to_dev(self._phys_positions(
            r, 0, s0, _pad_len(s0) if s0 else 0))
        past_k, past_v = self._gather(idx)
        with self._ctx():
            k_c, v_c = self.model.prefill_chunk(
                self.params, self._to_dev(toks), past_k, past_v, s0)
        self._scatter(k_c, v_c,
                      self._to_dev(self._phys_positions(r, s0, s1, cpad)))
        r.prefill_pos = s1
        self.metrics.prefill_chunks += 1
        self.metrics.prefill_tokens += take  # tokens actually computed
        if s1 >= len(ctx):
            self._finalize_prefill(r, ctx)

    def _prefill_atomic(self, r: ServeRequest) -> None:
        """Whole-context prefill for the recurrent families (their state
        cannot replay a chunk), padded to a pow2 bucket.  The true length
        rides along as ``lengths``, which gives the pad positions dt = 0,
        so the state equals an unpadded run's.  The slot's recurrent state
        is written in place; the hybrid's KV is scattered into the pool for
        valid positions only (pad positions land in scratch)."""
        ctx = r.prompt_tokens + r.output_tokens
        n = len(ctx)
        spad = _pad_len(n, quantum=32)
        toks = np.zeros((1, spad), np.int64)
        toks[0, :n] = ctx
        _, cache = self.model.prefill(
            self.params, {"tokens": self._to_dev(toks),
                          "lengths": self._to_dev(np.asarray([n]))})
        if self._has_kv:
            self._scatter(cache["k"], cache["v"], self._to_dev(
                self._phys_positions(r, 0, n, spad)))
        for name, t in self._cache["ssm"].items():
            t[:, r.slot] = cache["ssm"][name][:, 0].to(t.dtype)
        r.prefill_pos = n
        self.metrics.prefill_chunks += 1
        self.metrics.prefill_tokens += n
        self._finalize_prefill(r, ctx)

    def _run_prefills(self) -> None:
        """Advance every prefilling slot under the step's token budget:
        decode-ready slots each consume one budget token, the remainder
        goes to chunks."""
        prefilling = [rid for rid in self._running
                      if self._cache_len[self._requests[rid].slot] < 0]
        if not prefilling:
            return
        budget = None
        if self.max_tokens_per_step is not None:
            n_decoding = len(self._running) - len(prefilling)
            budget = max(0, self.max_tokens_per_step - n_decoding)
        for rid in prefilling:
            r = self._requests[rid]
            if not self.model.supports_chunked_prefill:
                self._prefill_atomic(r)
                continue
            remaining = r.context_len - r.prefill_pos
            cap = self.prefill_chunk or remaining
            if budget is not None:
                cap = min(cap, budget)
            take = min(cap, remaining)
            if take <= 0:
                continue            # budget exhausted: resume next step
            self._prefill_chunk_step(r, take)
            if budget is not None:
                budget -= take

    # ------------------------------------------------------------- pressure

    def _finish(self, r: ServeRequest, reason: str = "eos") -> None:
        r.state = RequestState.FINISHED
        r.finish_reason = reason
        r.ttlt = self.clock() - r.arrival
        self._release(r)
        self.scheduler.on_complete(r.request_id, r.generated)
        self.metrics.completed += 1
        if hasattr(self.scheduler, "calibration_summary"):
            self.metrics.calibration = self.scheduler.calibration_summary()

    def _relieve_pressure(self) -> None:
        """Decode growth that found no free block forces eviction until it
        fits, victims chosen by the scheduler's memory-aware eviction
        order; a sole resident request that fills the pool is truncated."""
        while self._needs_grow:
            rid = next(iter(self._needs_grow))
            r = self._requests.get(rid)
            if r is None or r.done or not self.kv.holds(rid):
                self._needs_grow.discard(rid)
                continue
            if self.kv.grow(rid, 1):
                self._sync_block_table(r)
                self._needs_grow.discard(rid)
                continue
            candidates = [x for x in self._running if self.kv.holds(x)]
            if candidates == [rid]:
                self._finish(r, reason="truncated")
                continue
            if not candidates:
                break
            victims = self.scheduler.eviction_order(
                candidates,
                held_tokens={x: self.kv.owned_tokens_of(x)
                             for x in candidates},
                swap_cost=lambda t: self.service_model.swap_time(
                    t, self.kv.block_size),
                memory_weight=self.memory_weight)
            self._preempt(self._requests[victims[0]])
            self.metrics.forced_evictions += 1

    # ------------------------------------------------------------- sampling

    def _sample_batch(self, logits: np.ndarray, slots: list[int],
                      temps: np.ndarray) -> np.ndarray:
        """One vectorized host sampling pass over the decode-ready slots:
        argmax for greedy rows, inverse-CDF categorical for the rest."""
        rows = logits[slots].astype(np.float64)
        out = np.empty(len(slots), np.int64)
        greedy = temps <= 0
        if greedy.any():
            out[greedy] = rows[greedy].argmax(axis=1)
        stoch = ~greedy
        if stoch.any():
            x = rows[stoch] / temps[stoch, None]
            x -= x.max(axis=1, keepdims=True)
            p = np.exp(x)
            p /= p.sum(axis=1, keepdims=True)
            u = self._rng.random(p.shape[0])
            cdf = np.cumsum(p, axis=1)
            out[stoch] = np.minimum((cdf < u[:, None]).sum(axis=1),
                                    p.shape[1] - 1)
        return out

    # ----------------------------------------------------------------- step

    def step(self) -> int:
        """One engine iteration. Returns number of running requests."""
        now = self.clock()
        self.scheduler.set_now(now)
        selected = self._select_running()
        sel = set(selected)

        for rid in list(self._running):
            if rid not in sel:
                self._preempt(self._requests[rid])

        for rid in selected:
            r = self._requests[rid]
            if r.state != RequestState.RUNNING:
                try:
                    self._admit(r)
                except RuntimeError:
                    if self.kv.blocks_for(r.context_len + 1) \
                            > self.kv.n_blocks:
                        # the context can never fit the physical pool
                        self.abort(rid, reason="infeasible_prompt")
                    # otherwise a transient shortfall: leave it queued
                    continue

        self._relieve_pressure()
        self._run_prefills()

        if not self._running:
            return 0
        ready = [(slot, rid) for slot, rid in sorted(self._slot_rid.items())
                 if self._cache_len[slot] >= 0
                 and rid not in self._needs_grow]
        if not ready:
            return len(self._running)

        if self.step_mode == "fused":
            self._decode_fused(ready)
        else:
            self._decode_orchestrated(ready)
        return len(self._running)

    def _decode_orchestrated(self, ready: list[tuple[int, str]]) -> None:
        """One full-width device step, logits shipped to the host,
        sampling and per-slot bookkeeping in numpy.  Slots that are
        mid-prefill (or free) point their table rows at the scratch page
        for this call."""
        tables_np = self._block_tables
        not_ready = self._cache_len < 0
        if not_ready.any():
            tables_np = tables_np.copy()
            tables_np[not_ready] = SCRATCH_BLOCK
        if self._orchestrated_runner is None:
            n = self.n_slots
            self._orchestrated_runner = StepRunner(self._step_graphs, {
                "tokens": ((n,), torch.int64),
                "cache_len": ((n,), torch.int32),
                "tables": ((n, self._max_pages), torch.int32)})
        logits_np = self._orchestrated_runner(
            self._orchestrated_body, tokens=self._last_token,
            cache_len=np.maximum(self._cache_len, 0), tables=tables_np)
        self.metrics.decode_iterations += 1

        slots = [s for s, _ in ready]
        rids = [rid for _, rid in ready]
        temps = np.array([self._requests[rid].temperature for rid in rids])
        toks = self._sample_batch(logits_np, slots, temps)

        progressing, progressed = [], []
        for slot, rid, tok in zip(slots, rids, toks):
            r = self._requests[rid]
            tok = int(tok)
            self._cache_len[slot] += 1
            self._last_token[slot] = tok
            r.output_tokens.append(tok)
            self.metrics.decode_tokens += 1
            if np.isnan(r.ttft):
                r.ttft = self.clock() - r.arrival
            if tok == r.eos_token:
                self._finish(r, reason="eos")
                continue
            if r.generated >= r.max_new_tokens \
                    or r.context_len >= self.max_seq_len - 1:
                self._finish(r, reason="length")
                continue
            progressing.append(rid)
            progressed.append(r.generated)
            # reserve the next token's block now; a False return is capacity
            # pressure, relieved by forced eviction at the next select
            if self.kv.grow(rid, 1):
                self._sync_block_table(r)
            else:
                self.metrics.grow_failures += 1
                self._needs_grow.add(rid)
        self.scheduler.on_progress_many(progressing, progressed)

    def _orchestrated_body(self, x: dict) -> torch.Tensor:
        """The orchestrated step on its runner's static inputs: (n_slots,
        V) f32 logits.  The pool and the recurrent state are written in
        place."""
        with self._ctx():
            logits, _ = self.model.decode_step_paged(
                self.params, x["tokens"][:, None], self._cache,
                x["cache_len"], x["tables"], page_size=self.block_size)
        if isinstance(logits, list):       # vocab-sharded: gather the row
            logits = self.plan.all_gather(logits, -1)
        return logits.float()

    def _fused_steps(self, lanes: np.ndarray, tables: np.ndarray,
                     temps: np.ndarray, *, n_steps: int,
                     all_greedy: bool) -> np.ndarray:
        """Advance every lane by up to ``n_steps`` tokens on the device.

        lanes: (7, nb) int64 host rows last token / cache_len / budget /
        cap / eos / request seed / tokens generated; tables: (nb, P)
        int32; temps: (nb,) f32.  They reach the device in one copy, and
        the step runs on the runner of its key (nb, P, n_steps,
        all_greedy).  Returns the host (nb, n_steps + 2) array [tokens...,
        emitted, finished], the one device->host transfer of the call."""
        nb, pb = tables.shape
        key = (nb, pb, n_steps, all_greedy)
        runner = self._fused_runners.get(key)
        if runner is None:
            runner = self._fused_runners[key] = StepRunner(
                self._step_graphs, {"lanes": ((7, nb), torch.int64),
                                    "tables": ((nb, pb), torch.int32),
                                    "temps": ((nb,), torch.float32)})
        return runner(lambda x: self._fused_body(
            x, n_steps=n_steps, all_greedy=all_greedy),
            lanes=lanes, tables=tables, temps=temps)

    def _fused_body(self, x: dict, *, n_steps: int,
                    all_greedy: bool) -> torch.Tensor:
        """The fused step on its runner's static inputs (which it only
        reads): the (nb, n_steps + 2) device result."""
        last, cl, budgets, caps, eos, seeds, counters = x["lanes"]
        tables, temps = x["tables"], x["temps"]
        nb = last.shape[0]
        dev = last.device
        scratch = torch.full_like(tables, SCRATCH_BLOCK)
        greedy = temps <= 0.0
        safe_t = torch.where(greedy, torch.ones_like(temps), temps)
        emitted = torch.zeros(nb, dtype=torch.int64, device=dev)
        fin = torch.zeros(nb, dtype=torch.bool, device=dev)
        buf = torch.full((nb, n_steps), -1, dtype=torch.int64, device=dev)
        for i in range(n_steps):
            act = (~fin) & (budgets > i)
            # inactive lanes (finished mid-loop, budget-paused, pad) ride
            # the scratch page: their KV write lands harmlessly; recurrent
            # state has no scratch page, so the step freezes their rows
            bt = torch.where(act[:, None], tables, scratch)
            with self._ctx():
                logits, _ = self.model.decode_step_paged(
                    self.params, last[:, None], self._cache, cl, bt,
                    page_size=self.block_size,
                    active=act if self._slot_state else None)
            if isinstance(logits, list):
                tok = self._sample_sharded(logits, greedy, safe_t, seeds,
                                           counters + i, all_greedy)
            else:
                tok = torch.argmax(logits, dim=-1)
                if not all_greedy:
                    # Gumbel-max draws keyed by (request seed, position):
                    # invariant to slot and preemption history
                    noise = gumbel_noise(self.seed, seeds, counters + i,
                                         logits.shape[-1])
                    st_tok = torch.argmax(logits.float() / safe_t[:, None]
                                          + noise, dim=-1)
                    tok = torch.where(greedy, tok, st_tok)
            emitted = emitted + act.long()
            fin = fin | (act & ((tok == eos) | (emitted >= caps)))
            last = torch.where(act, tok, last)
            cl = cl + act.long()
            buf[:, i] = torch.where(act, tok, torch.full_like(tok, -1))
        return torch.cat([buf, emitted[:, None], fin[:, None].long()], dim=1)

    def _sample_sharded(self, parts, greedy, safe_t, seeds, positions,
                        all_greedy: bool) -> torch.Tensor:
        """Argmax / Gumbel-max over vocab-sharded logits, partitioned: each
        shard takes the winner of its columns (the noise of each global
        token id, so the draw is the unsharded one) and the largest value
        wins, ties to the lowest global id, as ``torch.argmax`` over the
        whole row picks.  Only (value, id) per lane crosses shards."""
        best_v = best_i = None
        off = 0
        for part in parts:
            dev = part.device
            score = part.float()
            if not all_greedy:
                noise = gumbel_noise(self.seed, seeds.to(dev),
                                     positions.to(dev), part.shape[-1],
                                     offset=off)
                score = torch.where(greedy.to(dev)[:, None], score,
                                    score / safe_t.to(dev)[:, None] + noise)
            v, i = score.max(dim=-1)
            v, i = v.to(self.device), i.to(self.device) + off
            if best_v is None:
                best_v, best_i = v, i
            else:
                better = v > best_v
                best_v = torch.where(better, v, best_v)
                best_i = torch.where(better, i, best_i)
            off += part.shape[-1]
        return best_i

    def _decode_fused(self, ready: list[tuple[int, str]]) -> None:
        """Fused decode: one device call advances every ready lane by up
        to ``decode_steps`` tokens (attention, sampling, KV writes and
        EOS / length bookkeeping on the device); the host gets back one
        transfer and only does block accounting + scheduler feedback.
        Ready slots gather into a pow2 lane bucket (floor 8), and the
        table width rides its own pow2 ladder (floor 4); the recurrent
        families' lanes are slot-positional (nb = n_slots, lane = slot),
        since their state lives per slot."""
        n_steps = self.decode_steps
        plan = []                              # (slot, rid, budget, cap)
        for slot, rid in ready:
            r = self._requests[rid]
            cap = min(r.max_new_tokens - r.generated,
                      (self.max_seq_len - 1) - r.context_len)
            cap = max(1, cap)
            want = min(n_steps, cap)
            grant = self.kv.grow_upto(rid, want - 1) if want > 1 else 0
            if grant:
                self._sync_block_table(r)
            plan.append((slot, rid, grant + 1, cap))

        if self._slot_state:
            nb = self.n_slots
            lane_of = {slot: slot for slot, _ in ready}
        else:
            nb = _pow2_bucket(len(ready), floor=8, cap=self.n_slots)
            lane_of = {slot: j for j, (slot, _) in enumerate(ready)}
        p_used = max(len(self.kv.block_table(rid)) for _, rid in ready)
        pb = _pow2_bucket(p_used, floor=4, cap=self._max_pages)

        lanes = np.zeros((7, nb), np.int64)
        lanes[3] = 1                           # caps
        lanes[4] = -1                          # eos
        tables = np.full((nb, pb), SCRATCH_BLOCK, np.int32)
        temps = np.zeros(nb, np.float32)
        for slot, rid, budget, cap in plan:
            r = self._requests[rid]
            lane = lane_of[slot]
            lanes[:, lane] = (self._last_token[slot], self._cache_len[slot],
                              budget, cap, r.eos_token, _rid_seed(rid),
                              r.generated)
            tables[lane] = self._block_tables[slot, :pb]
            temps[lane] = r.temperature
        out = self._fused_steps(lanes, tables, temps, n_steps=n_steps,
                                all_greedy=bool((temps <= 0.0).all()))
        buf, emitted, fin = out[:, :n_steps], out[:, n_steps], out[:, -1]
        self.metrics.decode_iterations += n_steps
        self.metrics.fused_steps += 1

        progressing, progressed = [], []
        for slot, rid, _, _ in plan:
            lane = lane_of[slot]
            e = int(emitted[lane])
            if e == 0:
                continue
            r = self._requests[rid]
            toks = [int(t) for t in buf[lane, :e]]
            r.output_tokens.extend(toks)
            self._cache_len[slot] += e
            self._last_token[slot] = toks[-1]
            self.metrics.decode_tokens += e
            if np.isnan(r.ttft):
                r.ttft = self.clock() - r.arrival
            if fin[lane]:
                self._finish(r, reason="eos" if toks[-1] == r.eos_token
                             else "length")
                continue
            progressing.append(rid)
            progressed.append(r.generated)
            # restore the reserve-one-ahead invariant for the next write
            if self.kv.grow(rid, 1):
                self._sync_block_table(r)
            else:
                self.metrics.grow_failures += 1
                self._needs_grow.add(rid)
        self.scheduler.on_progress_many(progressing, progressed)

    # ------------------------------------------------------ compile bound

    @property
    def fused_compile_count(self) -> int:
        """Distinct shape keys the fused step has run: on the card with
        graphs on, the graphs captured for it (one per key); elsewhere the
        keys seen.  The counterpart of the reference's jit cache size; the
        port owns this counter, so it is never -1."""
        return len(self._fused_runners)

    def max_fused_compiles(self, n_steps_variants: int = 1) -> int:
        """Upper bound on ``fused_compile_count``: the bucket-ladder
        product.  Batch churn (admit / evict / finish) only moves shapes
        along the pow2 ladders; the final factor 2 is the all-greedy /
        mixed-sampling specialization."""
        b_ladder = 1 if self._slot_state \
            else _ladder_size(self.n_slots, floor=8)
        return b_ladder * _ladder_size(self._max_pages, floor=4) \
            * n_steps_variants * 2

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs this engine has captured (both decode steps)."""
        return self._step_graphs.captured

    # ------------------------------------------------------------ reports

    def sharding_report(self) -> dict | None:
        """Per-component sharding outcome on this engine's mesh (None on
        the single-device path); see ``ShardingPlan.describe``."""
        return None if self.plan is None else self.plan.describe()

    def stall_report(self) -> dict:
        """Live-state diagnosis: per-state request counts, queue depth,
        pool occupancy, pressure set — the payload of EngineStallError."""
        states = Counter(r.state.name for r in self._requests.values())
        waiting = [rid for rid, r in self._requests.items()
                   if not r.done and rid not in self._running]
        return {
            "request_states": dict(states),
            "queue_depth": len(waiting),
            "running": list(self._running),
            "needs_grow": sorted(self._needs_grow),
            "kv": self.kv.conservation(),
        }

    def run_until_done(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        if not self.has_work:
            return
        raise EngineStallError(
            f"run_until_done: step budget ({max_steps}) exhausted with "
            f"work still live — {self.stall_report()}")
