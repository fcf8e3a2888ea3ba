"""Block-table KV cache manager: paged device pool + host swap pool.

TPU adaptation of vLLM's paged block manager (DESIGN.md): KV memory is a
pool of fixed-size *token blocks* (``block_size`` tokens each).  A running
request owns

  * a *slot* — its row in the engine's decode batch (tokens / cache_len /
    block-table arrays), and
  * a *block table* — the ordered list of physical blocks holding its KV;
    logical token position ``p`` lives at block ``table[p // block_size]``,
    offset ``p % block_size``.

Physical block 0 is a reserved *scratch* block: inactive decode rows point
their tables at it, so masked lanes write harmlessly instead of corrupting
a neighbour.  Allocation is block-granular, which makes the accounting
*fragmentation-aware*: a request holding ``t`` tokens pins
``ceil(t / block_size)`` blocks, and admission is budgeted in blocks
(``budget_blocks`` — one authoritative accessor shared by ``can_admit``
and the engine's running-set selection), not in raw tokens.

Preemption is swap-based: ``swap_out`` moves a request's blocks to a host
pool (the engine attaches the gathered KV arrays as an opaque *payload*),
``swap_in`` re-allocates device blocks and returns the payload so the
engine can restore the cache without re-prefilling.  Recompute-mode
preemption is plain ``release`` (drop the KV, replay the context later).

This manager is deliberately *mesh-agnostic* (docs/sharded_serving.md):
under a sharded engine the physical pages stripe over the kv-head dim,
but tables, refcounts, the prefix index, and swap accounting all stay
host-side and authoritative — a payload is the gathered full-head array
(gather/scatter of per-shard slices is a pure relayout), so payloads,
and with them cluster migration, are mesh-width-agnostic.

Prefix sharing (copy-on-write)
------------------------------
Full blocks of *prompt* KV are content-addressed by a chain hash
(``h_i = hash((h_{i-1}, block_tokens))``, so a hash names the whole
prefix up to and including block ``i``).  The prefix index maps chain
hash -> physical block; ``match_prefix`` walks it to find the longest
resident block chain for an incoming prompt, and ``allocate_shared``
adopts those blocks by bumping their *refcount* instead of copying.
Every physical block is therefore in exactly one of three states:

  * **free**       — on the free list, unreferenced, no content tag;
  * **cached**     — refcount 0 but still holding indexed prefix KV;
                     reclaimable (counted in ``free_blocks``) and evicted
                     LRU when the free list runs dry;
  * **referenced** — refcount >= 1, held by that many live allocations.

``release``/``swap_out`` decrement refcounts; a block is only recycled
(to *cached* if it carries a prefix tag, else to *free*) when its count
hits zero.  ``fork_block`` is the copy-on-write primitive: it gives one
reader a private replacement for a shared block (the engine avoids ever
needing a data copy by capping matches below the last prompt position,
so the divergence point is block-aligned — see docs/serving_engine.md).

Accounting under sharing distinguishes *held* from *owned*: a request
holding a block with refcount ``r`` owns ``1/r`` of it, so
``owned_blocks`` is the true pool pressure and is what admission and
eviction charge.  For private-only workloads (sharing disabled) owned ==
held and every number below is identical to the pre-sharing manager.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["KVCacheManager", "BlockAllocation"]

SCRATCH_BLOCK = 0


@dataclass
class BlockAllocation:
    """Device-side state of one resident request.

    ``hashes[i]`` is the chain hash of ``blocks[i]`` for the leading
    *full prompt* blocks that participate in prefix sharing (shorter
    than ``blocks``: decode-grown and partial tail blocks are never
    hashed).  ``adopted`` counts the leading blocks that were adopted
    from the prefix index at allocation/swap-in time (their KV is
    already resident — the engine skips prefill / payload scatter for
    them).
    """

    slot: int
    tokens: int
    blocks: list[int] = field(default_factory=list)
    hashes: list[int] = field(default_factory=list)
    adopted: int = 0


@dataclass
class _HostAllocation:
    """Host-side state of one swapped-out request."""

    tokens: int
    n_blocks: int
    payload: Any = None
    # chain hashes of the leading prompt blocks at swap-out time, so
    # swap_in can re-match still-resident shared prefixes and restore
    # the share structure instead of scattering private copies.
    prefix_hashes: list[int] = field(default_factory=list)


class KVCacheManager:
    def __init__(self, n_slots: int, max_seq_len: int,
                 capacity_tokens: int | None = None,
                 watermark: float = 0.05,
                 block_size: int = 16,
                 swap_capacity_tokens: int | None = None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.capacity_tokens = capacity_tokens or n_slots * max_seq_len
        self.watermark = watermark
        # device pool: blocks 1..n_blocks are allocatable, 0 is scratch
        self.n_blocks = -(-self.capacity_tokens // block_size)
        # host pool (swap destination), in blocks; default: 2x device
        swap_cap = (2 * self.capacity_tokens if swap_capacity_tokens is None
                    else swap_capacity_tokens)
        self.swap_blocks = -(-swap_cap // block_size)
        self._free_slots = list(range(n_slots))[::-1]
        self._free_blocks = list(range(1, self.n_blocks + 1))[::-1]
        self._held: dict[str, BlockAllocation] = {}
        self._swapped: dict[str, _HostAllocation] = {}
        # --- prefix-sharing state -----------------------------------
        # refcount per *referenced* block (absent == not referenced)
        self._ref: dict[int, int] = {}
        # refcount-0 blocks still holding indexed prefix KV, in LRU
        # order (dict preserves insertion order; oldest evicted first)
        self._cached: dict[int, int] = {}
        # chain hash -> canonical physical block, and its inverse
        self._index: dict[int, int] = {}
        self._block_hash: dict[int, int] = {}

    # ---------------------------------------------------------------- sizing

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` (fragmentation-aware: the last
        block is pinned whole even when partially filled)."""
        return max(1, -(-int(tokens) // self.block_size))

    @property
    def pool_blocks(self) -> int:
        """Physical pool size in blocks, *including* the scratch block —
        the first dimension of the engine's paged KV tensors."""
        return self.n_blocks + 1

    @property
    def budget_blocks(self) -> int:
        """The authoritative admission budget, in blocks: total blocks
        minus the watermark reserve kept free for decode growth.  Both
        ``can_admit`` and the engine's running-set selection budget
        against this single number (previously each hand-rolled its own
        ``capacity * (1 - watermark)`` and they could drift).  Under
        prefix sharing the budget is consumed by *owned* (refcount-
        weighted) blocks, so N requests sharing a prefix charge it
        once, not N times."""
        return int(self.n_blocks * (1.0 - self.watermark))

    @property
    def admission_budget_tokens(self) -> int:
        """``budget_blocks`` in token units (block-quantized)."""
        return self.budget_blocks * self.block_size

    # ---------------------------------------------------------------- state

    @property
    def used_tokens(self) -> int:
        """Logical tokens held on device (excludes fragmentation)."""
        return sum(a.tokens for a in self._held.values())

    @property
    def used_blocks(self) -> int:
        """Distinct physical blocks referenced by live allocations (a
        shared block counts once)."""
        return len(self._ref)

    @property
    def owned_blocks(self) -> float:
        """Refcount-weighted blocks charged to live allocations: a block
        with refcount r charges 1/r to each of its r holders, so the
        total equals ``used_blocks`` while splitting the cost fairly.
        Equals ``used_blocks`` exactly for private-only allocations."""
        return sum(self.owned_blocks_of(rid) for rid in self._held)

    @property
    def frag_tokens(self) -> int:
        """Tokens pinned but unused inside partially-filled last blocks
        (private allocations; sharing makes this a lower bound)."""
        return self.used_blocks * self.block_size - self.used_tokens

    @property
    def free_blocks(self) -> int:
        """Reclaimable blocks: the free list plus refcount-0 cached
        prefix blocks (evicted LRU on demand)."""
        return len(self._free_blocks) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained for prefix reuse."""
        return len(self._cached)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def swapped_tokens(self) -> int:
        return sum(a.tokens for a in self._swapped.values())

    @property
    def swapped_blocks_used(self) -> int:
        return sum(a.n_blocks for a in self._swapped.values())

    def tokens_of(self, request_id: str) -> int:
        return self._held[request_id].tokens

    def slot_of(self, request_id: str) -> int:
        return self._held[request_id].slot

    def block_table(self, request_id: str) -> list[int]:
        return list(self._held[request_id].blocks)

    def holds(self, request_id: str) -> bool:
        return request_id in self._held

    def is_swapped(self, request_id: str) -> bool:
        return request_id in self._swapped

    def swapped_tokens_of(self, request_id: str) -> int:
        return self._swapped[request_id].tokens

    def owned_blocks_of(self, request_id: str) -> float:
        """Refcount-weighted block charge of one request (1/r per block
        with refcount r; == len(block_table) when fully private)."""
        return sum(1.0 / self._ref[b]
                   for b in self._held[request_id].blocks)

    def owned_tokens_of(self, request_id: str) -> float:
        """``owned_blocks_of`` in token units — the eviction cost proxy
        (a heavy sharer frees little real memory when evicted)."""
        return self.owned_blocks_of(request_id) * self.block_size

    def shared_excess_blocks(self, request_id: str) -> float:
        """Blocks held but not owned (0.0 when fully private)."""
        a = self._held[request_id]
        return len(a.blocks) - self.owned_blocks_of(request_id)

    def adopted_blocks_of(self, request_id: str) -> int:
        """Leading blocks adopted from the prefix index at allocate /
        swap-in time (their KV is already resident on device)."""
        return self._held[request_id].adopted

    def refcount_of(self, block: int) -> int:
        return self._ref.get(block, 0)

    def live_refcounts(self) -> dict[int, int]:
        """Snapshot of per-block refcounts for referenced blocks."""
        return dict(self._ref)

    # ------------------------------------------------------- prefix sharing

    def chain_hashes(self, token_ids) -> list[int]:
        """Chain hashes of the *full* blocks of ``token_ids``: entry i
        names the whole prefix ``token_ids[:(i+1)*block_size]``."""
        bs = self.block_size
        out: list[int] = []
        h = 0
        for i in range(len(token_ids) // bs):
            h = hash((h, tuple(int(t) for t in token_ids[i * bs:(i + 1) * bs])))
            out.append(h)
        return out

    def match_prefix(self, token_ids) -> tuple[int, list[int], list[int]]:
        """Longest indexed block-chain prefix of ``token_ids``.  Returns
        ``(matched_tokens, blocks, hashes)`` where ``blocks`` are the
        resident physical blocks holding that prefix's KV (matched_tokens
        == len(blocks) * block_size; all full blocks)."""
        blocks: list[int] = []
        hashes: list[int] = []
        for h in self.chain_hashes(token_ids):
            b = self._index.get(h)
            if b is None:
                break
            blocks.append(b)
            hashes.append(h)
        return len(blocks) * self.block_size, blocks, hashes

    def register_prefix(self, request_id: str, token_ids) -> int:
        """Publish ``request_id``'s full prompt blocks into the prefix
        index so later prompts can adopt them.  Only positions strictly
        below ``len(token_ids) - 1`` are published (the engine re-writes
        KV at the last context position when decode starts, so the block
        holding it must stay private — see ``ServingEngine``).  First
        writer wins: a hash already indexed keeps its canonical block.
        Returns the number of newly indexed blocks."""
        a = self._held[request_id]
        bs = self.block_size
        k = max(0, (len(token_ids) - 1) // bs)  # publishable full blocks
        k = min(k, len(a.blocks))
        hashes = self.chain_hashes(token_ids)[:k]
        if a.hashes and hashes[:len(a.hashes)] != a.hashes[:k]:
            raise RuntimeError(
                f"{request_id}: prompt hash chain diverged from the "
                "chain recorded at allocation")
        added = 0
        for i in range(len(a.hashes), k):
            h, b = hashes[i], a.blocks[i]
            a.hashes.append(h)
            if h not in self._index:
                self._index[h] = b
                self._block_hash[b] = h
                added += 1
        return added

    def fork_block(self, request_id: str, logical_idx: int
                   ) -> tuple[int, int] | None:
        """Copy-on-write: give ``request_id`` a private replacement for
        the shared block at ``blocks[logical_idx]`` ahead of a divergent
        write.  Returns ``(old_block, new_block)`` so the caller can copy
        the KV page device-side, or ``None`` if the block is already
        private (refcount 1).  Raises ``RuntimeError`` when no block can
        be reclaimed for the copy."""
        a = self._held[request_id]
        old = a.blocks[logical_idx]
        if self._ref[old] == 1:
            return None
        new = self._take_block()
        self._ref[new] = 1
        self._ref[old] -= 1
        a.blocks[logical_idx] = new
        # the fork diverges this request's content from the indexed
        # chain at logical_idx; truncate its published-chain record
        del a.hashes[logical_idx:]
        a.adopted = min(a.adopted, logical_idx)
        return old, new

    def check_prefix_index(self) -> None:
        """Rebuild the prefix index from per-block content tags over all
        live (referenced + cached) blocks and assert it equals the
        incrementally maintained one — the fuzz suite's index invariant.
        Raises ``RuntimeError`` on mismatch."""
        rebuilt = {}
        live = set(self._ref) | set(self._cached)
        for b in live:
            h = self._block_hash.get(b)
            if h is not None:
                rebuilt[h] = b
        if rebuilt != self._index:
            stale = {h: b for h, b in self._index.items()
                     if rebuilt.get(h) != b}
            missing = {h: b for h, b in rebuilt.items()
                       if self._index.get(h) != b}
            raise RuntimeError(
                f"prefix index drifted: stale={stale} missing={missing}")
        if set(self._block_hash) != set(self._index.values()):
            raise RuntimeError("block hash tags are not the inverse of "
                               "the prefix index")

    # ------------------------------------------------------ block recycling

    def _take_block(self) -> int:
        """Pop a physical block for writing: free list first, then evict
        the LRU cached prefix block (dropping its index entry)."""
        if self._free_blocks:
            return self._free_blocks.pop()
        if self._cached:
            b = next(iter(self._cached))
            del self._cached[b]
            h = self._block_hash.pop(b)
            if self._index.get(h) == b:
                del self._index[h]
            return b
        raise RuntimeError("no free blocks")

    def _incref(self, block: int) -> None:
        """Adopt a shared block: bump its refcount, un-caching it if it
        was sitting at refcount 0."""
        if block in self._ref:
            self._ref[block] += 1
        else:
            self._cached.pop(block, None)
            self._ref[block] = 1

    def _decref(self, block: int) -> None:
        """Drop one reference; at zero the block goes to the cached tier
        (if it still carries an index tag) or back to the free list."""
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return
        del self._ref[block]
        h = self._block_hash.get(block)
        if h is not None:
            self._cached[block] = h  # LRU tail == most recently released
        else:
            self._free_blocks.append(block)

    # ---------------------------------------------------------- invariants

    def conservation(self) -> dict:
        """Snapshot of the pool accounting the conservation invariant is
        stated over (free + cached + referenced == device pool; swap
        usage <= host pool)."""
        return {
            "n_blocks": self.n_blocks,
            "free_blocks": len(self._free_blocks),
            "cached_blocks": len(self._cached),
            "held_blocks": self.used_blocks,
            "owned_blocks": self.owned_blocks,
            "free_slots": len(self._free_slots),
            "held_slots": len(self._held),
            "n_slots": self.n_slots,
            "swapped_blocks": self.swapped_blocks_used,
            "swap_blocks": self.swap_blocks,
        }

    def assert_conserved(self) -> None:
        """Block/slot conservation: every device block is in exactly one
        of {free, cached, referenced} (scratch excluded from all three),
        per-block refcounts equal the number of live allocations holding
        the block, every slot is free or bound once, and the host pool
        is within capacity.  Raises ``RuntimeError`` with the full
        ledger on any violation — the fault-injection harness and the
        allocator fuzz suite call this after every operation."""
        errs = []
        multiplicity: dict[int, int] = {}
        for a in self._held.values():
            if len(set(a.blocks)) != len(a.blocks):
                errs.append("block appears twice in one allocation")
            for b in a.blocks:
                multiplicity[b] = multiplicity.get(b, 0) + 1
        referenced = set(multiplicity)
        free = set(self._free_blocks)
        cached = set(self._cached)
        if len(free) != len(self._free_blocks):
            errs.append("duplicate free blocks")
        if multiplicity != self._ref:
            errs.append("refcounts != live readers")
        if free & referenced:
            errs.append("block both free and referenced")
        if free & cached:
            errs.append("block both free and cached")
        if cached & referenced:
            errs.append("block both cached and referenced")
        if (len(self._free_blocks) + len(cached) + len(referenced)
                != self.n_blocks):
            errs.append("free+cached+referenced blocks != pool")
        if SCRATCH_BLOCK in free | cached | referenced:
            errs.append("scratch block entered the pool")
        for b, h in self._block_hash.items():
            if self._index.get(h) != b:
                errs.append("block hash tag without matching index entry")
                break
        if not set(self._index.values()) <= referenced | cached:
            errs.append("prefix index points at a dead block")
        if not cached <= set(self._block_hash):
            errs.append("cached block without a content tag")
        held_slots = [a.slot for a in self._held.values()]
        if sorted(self._free_slots + held_slots) != list(range(self.n_slots)):
            errs.append("slot ledger broken")
        if self.swapped_blocks_used > self.swap_blocks:
            errs.append("host swap pool over capacity")
        if set(self._held) & set(self._swapped):
            errs.append("request both resident and swapped")
        if errs:
            raise RuntimeError(
                f"KV conservation violated: {errs}; {self.conservation()}")

    # ------------------------------------------------------------ admission

    def can_admit(self, context_len: int, growth_reserve: int = 0,
                  shared_blocks: int = 0) -> bool:
        if not self._free_slots:
            return False
        need = self.blocks_for(context_len + growth_reserve) \
            - int(shared_blocks)
        if need > self.free_blocks:
            return False
        return self.owned_blocks + max(0, need) <= self.budget_blocks

    def allocate(self, request_id: str, context_len: int) -> int:
        """Claim a slot + the blocks for ``context_len`` tokens; returns
        the slot index."""
        if request_id in self._held:
            raise KeyError(f"{request_id} already holds a slot")
        if not self._free_slots:
            raise RuntimeError("no free slots")
        need = self.blocks_for(context_len)
        if need > self.free_blocks:
            raise RuntimeError(
                f"no free blocks: need {need}, have {self.free_blocks}")
        slot = self._free_slots.pop()
        blocks = [self._take_block() for _ in range(need)]
        for b in blocks:
            self._ref[b] = 1
        self._held[request_id] = BlockAllocation(slot, int(context_len),
                                                 blocks)
        return slot

    def allocate_shared(self, request_id: str, context_len: int,
                        shared_blocks: list[int],
                        shared_hashes: list[int]) -> int:
        """Claim a slot + blocks for ``context_len`` tokens, adopting
        ``shared_blocks`` (a ``match_prefix`` result: resident blocks
        holding this prompt's leading full blocks) by reference instead
        of allocating and re-filling them.  Returns the slot index."""
        if request_id in self._held:
            raise KeyError(f"{request_id} already holds a slot")
        if len(shared_blocks) != len(shared_hashes):
            raise ValueError("shared_blocks/shared_hashes length mismatch")
        if len(shared_blocks) * self.block_size > int(context_len):
            raise ValueError("shared prefix longer than the context")
        if not self._free_slots:
            raise RuntimeError("no free slots")
        need = self.blocks_for(context_len) - len(shared_blocks)
        # adopting a cached block consumes a reclaimable block too
        reclaimable = self.free_blocks \
            - sum(1 for b in shared_blocks if b in self._cached)
        if need > reclaimable:
            raise RuntimeError(
                f"no free blocks: need {need}, have {reclaimable}")
        slot = self._free_slots.pop()
        for b in shared_blocks:
            self._incref(b)
        blocks = list(shared_blocks)
        for _ in range(max(0, need)):
            b = self._take_block()
            self._ref[b] = 1
            blocks.append(b)
        self._held[request_id] = BlockAllocation(
            slot, int(context_len), blocks,
            hashes=list(shared_hashes), adopted=len(shared_blocks))
        return slot

    def grow(self, request_id: str, new_tokens: int = 1) -> bool:
        """Account for decode growth, appending blocks when the request
        crosses a block boundary.  Returns False — with NO partial
        mutation — when the growth does not fit (``max_seq_len`` hit, or
        the free pool is exhausted: capacity-forced eviction time)."""
        a = self._held[request_id]
        t_new = a.tokens + int(new_tokens)
        if t_new > self.max_seq_len:
            return False
        need = self.blocks_for(t_new) - len(a.blocks)
        if need > self.free_blocks:
            return False
        for _ in range(need):
            b = self._take_block()
            self._ref[b] = 1
            a.blocks.append(b)
        a.tokens = t_new
        return True

    def grow_upto(self, request_id: str, new_tokens: int) -> int:
        """Grow by as many of ``new_tokens`` as currently fit (bounded by
        ``max_seq_len`` and the free pool); returns the granted token
        count.  The fused multi-step decode uses this to reserve N
        tokens of KV ahead of one device call — a partial grant bounds
        that call's per-lane step budget instead of failing it."""
        granted = 0
        while granted < new_tokens and self.grow(request_id, 1):
            granted += 1
        return granted

    def release(self, request_id: str) -> int:
        """Drop the slot + this request's references (completion,
        recompute-eviction, abort).  Blocks are recycled only at
        refcount zero; indexed prefix blocks park in the cached tier."""
        a = self._held.pop(request_id)
        self._free_slots.append(a.slot)
        for b in reversed(a.blocks):
            self._decref(b)
        return a.slot

    # ----------------------------------------------------------------- swap

    def can_swap_out(self, request_id: str) -> bool:
        """Host pool headroom for this request's blocks."""
        a = self._held[request_id]
        return (self.swapped_blocks_used + len(a.blocks)
                <= self.swap_blocks)

    def swap_out(self, request_id: str, payload: Any = None) -> int:
        """Move a resident request to the host pool.  ``payload`` is the
        engine-gathered KV (opaque here); device references + slot are
        dropped, but the prefix hash chain rides along so swap_in can
        re-adopt any still-resident shared blocks.  Returns the number
        of tokens swapped."""
        if not self.can_swap_out(request_id):
            raise RuntimeError(f"host swap pool full for {request_id}")
        a = self._held.pop(request_id)
        self._free_slots.append(a.slot)
        for b in reversed(a.blocks):
            self._decref(b)
        self._swapped[request_id] = _HostAllocation(
            tokens=a.tokens, n_blocks=len(a.blocks), payload=payload,
            prefix_hashes=list(a.hashes))
        return a.tokens

    def can_swap_in(self, request_id: str, growth_reserve: int = 0) -> bool:
        return self.can_admit(self._swapped[request_id].tokens
                              + growth_reserve)

    def swap_in(self, request_id: str) -> tuple[int, Any]:
        """Restore a swapped request onto the device: re-matches its
        recorded prefix chain against the index (adopting any blocks
        that are still resident), allocates private blocks for the rest
        and returns ``(slot, payload)`` so the engine can scatter the
        saved KV back — ``adopted_blocks_of`` tells it how many leading
        blocks to skip."""
        host = self._swapped[request_id]
        if not self._free_slots:
            raise RuntimeError("no free slots")
        shared: list[int] = []
        hashes: list[int] = []
        for h in host.prefix_hashes:
            b = self._index.get(h)
            if b is None:
                break
            shared.append(b)
            hashes.append(h)
        need = self.blocks_for(host.tokens) - len(shared)
        reclaimable = self.free_blocks \
            - sum(1 for b in shared if b in self._cached)
        if need > reclaimable:
            raise RuntimeError(
                f"no free blocks: need {need}, have {reclaimable}")
        del self._swapped[request_id]
        slot = self._free_slots.pop()
        for b in shared:
            self._incref(b)
        blocks = list(shared)
        for _ in range(max(0, need)):
            b = self._take_block()
            self._ref[b] = 1
            blocks.append(b)
        self._held[request_id] = BlockAllocation(
            slot, host.tokens, blocks,
            hashes=hashes, adopted=len(shared))
        return slot, host.payload

    def drop_swapped(self, request_id: str) -> None:
        """Discard a host-side allocation (abort, or fall back to
        recompute when restoring is no longer worth it)."""
        self._swapped.pop(request_id, None)
