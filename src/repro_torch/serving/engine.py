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
        3. admit newcomers (swap-ins scatter their saved blocks back;
           others prefill in chunks through ``Model.prefill_chunk``);
        4. relieve capacity pressure by forced eviction;
        5. decode every ready slot through the paged pool;
        6. sample and feed completions back to the scheduler.

``step_mode="fused"`` (default) runs stages 5-6 as a Python loop of
device ops over ``decode_steps`` tokens: argmax (or Gumbel-max) sampling
and the per-lane length / EOS bookkeeping stay on the device, and the host
gets one (tokens, emitted, finished) transfer per call.
``step_mode="orchestrated"`` ships logits to the host every token and
samples with numpy, as the reference's parity oracle does.

KV memory is a paged pool: (L, n_pages, page, KV, dh) bf16 tensors shared
by the batch, a per-slot block table mapping logical positions to
physical pages (page 0 = scratch, where masked lanes write), and host
tensors holding preempted requests' KV.  The pool is updated in place.

Not ported yet, and refused rather than ignored: tensor-parallel serving
(``tp``/``mesh``, ROADMAP Queue A 10), the memory preflight
(``device_memory_gb``, Queue A 11), prefix sharing (Queue A 5) and the
atomic (non-chunked) prefill of the recurrent families (Queue A 7).
"""

from __future__ import annotations

import time
import zlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.scheduler import Scheduler
from ..kernels.bucketing import pow2_bucket as _pow2_bucket
from ..models import Model
from ..simulator.service_model import ServiceModel
from .kv_cache import SCRATCH_BLOCK, KVCacheManager
from .metrics import EngineMetrics
from .request import RequestState, ServeRequest

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
                 vocab: int) -> torch.Tensor:
    """(lanes, vocab) f32 Gumbel noise from a counter-based hash of
    (engine seed, request seed, position, token id): plain integer torch
    ops, so the CPU and the card draw the same numbers, and a lane's draw
    does not depend on its slot."""
    dev = rid_seeds.device
    key = _mix32(_mix32(rid_seeds.long() ^ (seed & _MASK32))
                 ^ positions.long())
    col = _mix32(torch.arange(vocab, device=dev, dtype=torch.int64)
                 + 0x632BE5AB)
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
        if self.parallel not in ("exact", "efficient"):
            raise ValueError(
                f"bad parallel {self.parallel!r}: expected 'exact' or "
                "'efficient'")
        if self.tp != 1 or self.mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1 / mesh) is not ported yet: "
                "ROADMAP Queue A 10")
        if self.device_memory_gb is not None:
            raise NotImplementedError(
                "the device-memory preflight (device_memory_gb) is not "
                "ported yet: ROADMAP Queue A 11")
        if self.prefix_sharing:
            raise NotImplementedError(
                "prefix sharing is not ported yet: ROADMAP Queue A 5")
        if not self.model.supports_chunked_prefill:
            raise NotImplementedError(
                "atomic prefill (recurrent families) is not ported yet: "
                "ROADMAP Queue A 7")
        self.device = torch.device(self.device)
        self.kv = KVCacheManager(
            self.n_slots, self.max_seq_len, self.capacity_tokens,
            block_size=self.block_size,
            swap_capacity_tokens=self.swap_capacity_tokens)
        if self.params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = self.model.init(gen)
        if self.service_model is None:
            self.service_model = ServiceModel()
        self.metrics = EngineMetrics()
        self._rng = np.random.default_rng(self.seed)
        self._cache = self.model.init_paged_cache(
            self.kv.pool_blocks, self.block_size, self.n_slots,
            device=self.device)
        self._max_pages = -(-self.max_seq_len // self.block_size)
        self._block_tables = np.full((self.n_slots, self._max_pages),
                                     SCRATCH_BLOCK, np.int32)
        # cache_len < 0 marks a slot that is not decode-ready (free, or
        # still prefilling); the decode step masks it to 0
        self._cache_len = np.full(self.n_slots, -1, np.int64)
        self._last_token = np.zeros(self.n_slots, np.int64)
        self._slot_rid: dict[int, str] = {}
        self._needs_grow: set[str] = set()

    # ---------------------------------------------------------- device ops

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _flat_pools(self):
        """(L, n_pages * page, KV, dh) views of the K and V pools."""
        k, v = self._cache["k"], self._cache["v"]
        shape = (k.shape[0], -1) + tuple(k.shape[3:])
        return k.view(shape), v.view(shape)

    def _gather(self, idx: torch.Tensor):
        fk, fv = self._flat_pools()
        return fk[:, idx][:, None], fv[:, idx][:, None]

    def _scatter(self, ks, vs, idx: torch.Tensor) -> None:
        # in place: the chunk's KV is written straight into the pool
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
        idx = self._to_dev(np.asarray(blocks, np.int64))
        return {
            "cache_len": int(self._cache_len[slot]),
            "last_token": int(self._last_token[slot]),
            "prefill_pos": r.prefill_pos,
            "k": self._cache["k"][:, idx].cpu(),
            "v": self._cache["v"][:, idx].cpu(),
        }

    def _restore_payload(self, r: ServeRequest, payload: dict) -> None:
        slot = r.slot
        blocks = self.kv.block_table(r.request_id)
        skip = self.kv.adopted_blocks_of(r.request_id)
        if len(blocks) > skip:
            idx = self._to_dev(np.asarray(blocks[skip:], np.int64))
            # in place: the saved pages go straight back into the pool
            self._cache["k"][:, idx] = payload["k"][:, skip:].to(self.device)
            self._cache["v"][:, idx] = payload["v"][:, skip:].to(self.device)
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
        if s0 == 0:
            shp = self._cache["k"].shape
            past_k = torch.zeros((shp[0], 1, 0) + tuple(shp[3:]),
                                 dtype=torch.bfloat16, device=self.device)
            past_v = past_k
        else:
            idx = self._to_dev(self._phys_positions(r, 0, s0, _pad_len(s0)))
            past_k, past_v = self._gather(idx)
        k_c, v_c = self.model.prefill_chunk(self.params, self._to_dev(toks),
                                            past_k, past_v, s0)
        self._scatter(k_c, v_c,
                      self._to_dev(self._phys_positions(r, s0, s1, cpad)))
        r.prefill_pos = s1
        self.metrics.prefill_chunks += 1
        self.metrics.prefill_tokens += take  # tokens actually computed
        if s1 >= len(ctx):
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
        """One full-width device forward, logits shipped to the host,
        sampling and per-slot bookkeeping in numpy.  Slots that are
        mid-prefill (or free) point their table rows at the scratch page
        for this call."""
        tables_np = self._block_tables
        not_ready = self._cache_len < 0
        if not_ready.any():
            tables_np = tables_np.copy()
            tables_np[not_ready] = SCRATCH_BLOCK
        logits, self._cache = self.model.decode_step_paged(
            self.params, self._to_dev(self._last_token[:, None]),
            self._cache,
            self._to_dev(np.maximum(self._cache_len, 0).astype(np.int32)),
            self._to_dev(tables_np), page_size=self.block_size)
        logits_np = logits.float().cpu().numpy()
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

    def _fused_steps(self, lanes: np.ndarray, tables: np.ndarray,
                     temps: np.ndarray, *, n_steps: int,
                     all_greedy: bool) -> np.ndarray:
        """Advance every lane by up to ``n_steps`` tokens on the device.

        lanes: (7, nb) int64 host rows last token / cache_len / budget /
        cap / eos / request seed / tokens generated; tables: (nb, P)
        int32; temps: (nb,) f32.  Each moves to the device in one copy.
        Returns the host (nb, n_steps + 2) array [tokens..., emitted,
        finished], the one device->host transfer of the call."""
        dev = self.device
        last, cl, budgets, caps, eos, seeds, counters = self._to_dev(lanes)
        nb = last.shape[0]
        tables = self._to_dev(tables)
        scratch = torch.full_like(tables, SCRATCH_BLOCK)
        temps = self._to_dev(temps)
        greedy = temps <= 0.0
        safe_t = torch.where(greedy, torch.ones_like(temps), temps)
        emitted = torch.zeros(nb, dtype=torch.int64, device=dev)
        fin = torch.zeros(nb, dtype=torch.bool, device=dev)
        buf = torch.full((nb, n_steps), -1, dtype=torch.int64, device=dev)
        for i in range(n_steps):
            act = (~fin) & (budgets > i)
            # inactive lanes (finished mid-loop, budget-paused, pad) ride
            # the scratch page: their KV write lands harmlessly
            bt = torch.where(act[:, None], tables, scratch)
            logits, self._cache = self.model.decode_step_paged(
                self.params, last[:, None], self._cache, cl, bt,
                page_size=self.block_size)
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
        return torch.cat([buf, emitted[:, None], fin[:, None].long()],
                         dim=1).cpu().numpy()

    def _decode_fused(self, ready: list[tuple[int, str]]) -> None:
        """Fused decode: one device call advances every ready lane by up
        to ``decode_steps`` tokens (attention, sampling, KV writes and
        EOS / length bookkeeping on the device); the host gets back one
        transfer and only does block accounting + scheduler feedback.
        Ready slots gather into a pow2 lane bucket (floor 8), and the
        table width rides its own pow2 ladder (floor 4)."""
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

    # ------------------------------------------------------------ reports

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
