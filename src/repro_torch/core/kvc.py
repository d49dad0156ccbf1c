"""Block-based KV-cache manager (the paper's allocation substrate).

Supports every allocation discipline the paper compares:
  * exact-allocation  (EconoServe/MultiRes: prompt + padded predicted RL)
  * max-allocation    (ORCA/FastServe/SRTF: prompt + model max RL)
  * block-allocation  (vLLM/Sarathi: one block at a time, can fail mid-run)

The EconoServe PT reserve (§3.3) is a *watermark*, not a physical
partition — blocks are fungible pages. GT-side allocations must leave
``reserve_target`` blocks effectively set aside; PT admissions may dip into
that set-aside (tracked by ``reserve_in_use``). When a PT-phase request is
scheduled as a GT, its reserve charge is released (pure bookkeeping), which
gives freed blocks first-dibs back to the reserve — the rolling budget that
lets EconoServe add PTs every iteration.

Accounting distinguishes *allocated* from *used* tokens: KVC utilization
(the paper's headline metric) is used/capacity; exact-allocation's gap
between the two is exactly what KVCPipe closes. Both are maintained as
running counters — the simulator reads them every iteration, so they must
be O(1), not O(#allocations).

The *swap ledger* tracks per-rid KV page images offloaded to host memory
(rung 2 of the pressure-degradation ladder: lending → host swap →
recompute → shed). The ledger holds token extents only — the actual page
bytes live engine-side — under a bounded ``host_pool_tokens`` budget.
Registering past the budget evicts the oldest unpinned images (those
requests degrade one rung, to recompute); pinned images (in-flight
swap-in) are never evicted. ``shrink`` models a live capacity squeeze:
blocks that cannot be removed immediately are parked in
``pending_shrink`` and harvested as allocations free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


class AllocationError(Exception):
    pass


def blocks_for(tokens: int, block_size: int) -> int:
    return -(-max(0, tokens) // block_size)


@dataclass
class Allocation:
    blocks: int = 0
    reserve_blocks: int = 0     # portion charged against the PT reserve
    used_tokens: int = 0
    lent_tokens: int = 0        # KVCPipe: capacity granted inside a host span


@dataclass
class SwapEntry:
    """One host-offloaded KV image: token extent + eviction protection."""
    tokens: int = 0
    pinned: bool = False        # in-flight swap-in: never evicted


class BlockKVC:
    def __init__(self, capacity_tokens: int, block_size: int = 32,
                 reserve_frac: float = 0.0,
                 host_pool_tokens: Optional[int] = None):
        self.block_size = block_size
        self.total_blocks = capacity_tokens // block_size
        self.reserve_target = int(self.total_blocks * reserve_frac)
        self.free_blocks = self.total_blocks
        self.reserve_in_use = 0
        self.allocs: Dict[int, Allocation] = {}
        self.n_failures = 0
        self.n_allocs = 0
        self._used_tokens = 0          # running sum of per-alloc used_tokens
        # -- host swap ledger (rung 2) --
        self.host_pool_tokens = (self.total_blocks * block_size
                                 if host_pool_tokens is None
                                 else int(host_pool_tokens))
        self.swapped: Dict[int, SwapEntry] = {}   # insertion order = age
        self.host_used = 0
        self.n_swap_outs = 0
        self.n_swap_ins = 0
        self.n_host_evictions = 0
        # -- live capacity squeeze --
        self.pending_shrink = 0        # blocks owed, harvested by free()
        self.n_shrinks = 0             # squeezes applied (gates rung-4 shed)

    # ------------------------------------------------------------------ #
    @property
    def capacity_tokens(self) -> int:
        return self.total_blocks * self.block_size

    @property
    def reserve_set_aside(self) -> int:
        """Blocks currently held back for PT admission."""
        return max(0, self.reserve_target - self.reserve_in_use)

    @property
    def free_general(self) -> int:
        """Blocks a GT-side allocation may take."""
        return max(0, self.free_blocks - self.reserve_set_aside)

    @property
    def free_reserve(self) -> int:
        """Reserve headroom a PT admission may take (bounded by real free)."""
        return min(self.reserve_set_aside, self.free_blocks)

    @property
    def allocated_blocks(self) -> int:
        return self.total_blocks - self.free_blocks

    @property
    def used_tokens(self) -> int:
        return self._used_tokens

    @property
    def utilization(self) -> float:
        return self.used_tokens / max(1, self.capacity_tokens)

    @property
    def allocated_frac(self) -> float:
        return self.allocated_blocks / max(1, self.total_blocks)

    def free_tokens(self) -> int:
        return self.free_general * self.block_size

    # ------------------------------------------------------------------ #
    # GT-side (general pool, respects the reserve watermark)
    # ------------------------------------------------------------------ #
    def can_allocate(self, tokens: int) -> bool:
        return blocks_for(tokens, self.block_size) <= self.free_general

    def allocate(self, rid: int, tokens: int) -> bool:
        """Exact/max allocation. All-or-nothing."""
        b = blocks_for(tokens, self.block_size)
        if b > self.free_general:
            self.n_failures += 1
            return False
        self.free_blocks -= b
        self.allocs.setdefault(rid, Allocation()).blocks += b
        self.n_allocs += 1
        return True

    def extend(self, rid: int, blocks: int = 1) -> bool:
        """vLLM-style incremental growth (counted as an allocation op)."""
        if blocks > self.free_general:
            self.n_failures += 1
            return False
        self.free_blocks -= blocks
        self.allocs.setdefault(rid, Allocation()).blocks += blocks
        self.n_allocs += 1
        return True

    # ------------------------------------------------------------------ #
    # PT-side (may dip into the reserve set-aside)
    # ------------------------------------------------------------------ #
    def allocate_reserve(self, rid: int, blocks: int = 1) -> bool:
        if blocks > self.free_reserve:
            return False
        self.free_blocks -= blocks
        self.reserve_in_use += blocks
        self.allocs.setdefault(rid, Allocation()).reserve_blocks += blocks
        return True

    def release_reserve(self, rid: int) -> None:
        """The request left the PT phase: stop charging its blocks to the
        reserve (pure bookkeeping; freed blocks will replenish it)."""
        a = self.allocs.get(rid)
        if a is None or a.reserve_blocks == 0:
            return
        self.reserve_in_use -= a.reserve_blocks
        a.blocks += a.reserve_blocks
        a.reserve_blocks = 0

    # ------------------------------------------------------------------ #
    def set_used(self, rid: int, tokens: int) -> None:
        a = self.allocs.get(rid)
        if a is not None:
            self._used_tokens += tokens - a.used_tokens
            a.used_tokens = tokens

    def add_used(self, rid: int, tokens: int = 1) -> None:
        a = self.allocs.get(rid)
        if a is not None:
            a.used_tokens += tokens
            self._used_tokens += tokens

    def allocated_tokens(self, rid: int) -> int:
        a = self.allocs.get(rid)
        return 0 if a is None else (a.blocks + a.reserve_blocks) * self.block_size

    def free(self, rid: int) -> int:
        """Release a request's allocation. Returns tokens freed."""
        a = self.allocs.pop(rid, None)
        if a is None:
            return 0
        self.free_blocks += a.blocks + a.reserve_blocks
        self.reserve_in_use -= a.reserve_blocks
        self._used_tokens -= a.used_tokens
        if self.pending_shrink:
            h = min(self.pending_shrink, self.free_blocks)
            self.free_blocks -= h
            self.total_blocks -= h
            self.pending_shrink -= h
        return (a.blocks + a.reserve_blocks) * self.block_size

    # ------------------------------------------------------------------ #
    # host swap ledger (pressure ladder rung 2)
    # ------------------------------------------------------------------ #
    def swap_register(self, rid: int, tokens: int) -> Optional[List[int]]:
        """Record a host-offloaded KV image of ``tokens`` extent.

        Returns the rids of older unpinned images evicted to make room
        (each degrades one rung, to recompute), or ``None`` when the
        image cannot fit the budget even after evicting everything
        unpinned — the caller must drop the image and recompute.
        """
        assert rid not in self.swapped, rid
        tokens = max(0, tokens)
        if tokens > self.host_pool_tokens:
            return None
        evicted: List[int] = []
        if self.host_used + tokens > self.host_pool_tokens:
            freed = 0
            for old_rid, e in self.swapped.items():
                if e.pinned:
                    continue
                evicted.append(old_rid)
                freed += e.tokens
                if self.host_used - freed + tokens <= self.host_pool_tokens:
                    break
            if self.host_used - freed + tokens > self.host_pool_tokens:
                return None            # everything left is pinned
            for old_rid in evicted:    # fits: commit the evictions
                self.host_used -= self.swapped.pop(old_rid).tokens
                self.n_host_evictions += 1
        self.swapped[rid] = SwapEntry(tokens=tokens)
        self.host_used += tokens
        self.n_swap_outs += 1
        return evicted

    def swap_release(self, rid: int, restored: bool = False) -> int:
        """Drop a ledger entry (image restored, dropped, or request done).
        Returns the tokens released; counts a swap-in when ``restored``."""
        e = self.swapped.pop(rid, None)
        if e is None:
            return 0
        self.host_used -= e.tokens
        if restored:
            self.n_swap_ins += 1
        return e.tokens

    def swap_pin(self, rid: int) -> None:
        e = self.swapped.get(rid)
        if e is not None:
            e.pinned = True

    def swap_unpin(self, rid: int) -> None:
        e = self.swapped.get(rid)
        if e is not None:
            e.pinned = False

    def swapped_tokens(self, rid: int) -> int:
        e = self.swapped.get(rid)
        return 0 if e is None else e.tokens

    # ------------------------------------------------------------------ #
    def shrink(self, tokens: int) -> int:
        """Live capacity squeeze (chaos ``squeeze`` event): remove up to
        ``tokens`` worth of blocks. Blocks still held by allocations are
        owed — parked in ``pending_shrink`` and harvested as requests
        free. Returns blocks removed immediately. Never invalidates a
        no-admission certificate: capacity only shrinks."""
        want = blocks_for(tokens, self.block_size)
        now = min(want, self.free_blocks)
        self.free_blocks -= now
        self.total_blocks -= now
        self.pending_shrink += want - now
        self.reserve_target = max(self.reserve_in_use,
                                  min(self.reserve_target, self.total_blocks))
        self.n_shrinks += 1
        return now

    # ------------------------------------------------------------------ #
    def publish_metrics(self, registry, **labels) -> None:
        """Publish the cache's block/token accounting into a
        ``repro_torch.obs`` registry (names: ``kvc_<noun>_<unit>``)."""
        ln = tuple(sorted(labels))

        def c(name, help, value):
            registry.counter(name, help, ln).labels(**labels).inc_to(value)

        def g(name, help, value):
            registry.gauge(name, help, ln).labels(**labels).set(value)

        g("kvc_total_blocks", "current capacity in blocks",
          self.total_blocks)
        g("kvc_free_blocks", "blocks free", self.free_blocks)
        g("kvc_occupied_blocks", "blocks held by live allocations",
          self.allocated_blocks)
        g("kvc_used_tokens", "tokens actually written", self.used_tokens)
        g("kvc_allocated_frac", "allocated / total blocks",
          self.allocated_frac)
        g("kvc_utilization_frac", "used tokens / capacity (the paper's "
          "headline metric)", self.utilization)
        g("kvc_reserve_in_use_blocks", "PT-reserve blocks charged",
          self.reserve_in_use)
        g("kvc_reserve_target_blocks", "PT-reserve watermark",
          self.reserve_target)
        c("kvc_allocs_total", "allocation operations", self.n_allocs)
        c("kvc_alloc_failures_total", "runtime allocation failures "
          "(Table 1)", self.n_failures)
        c("kvc_swap_outs_total", "KV images registered to the host pool",
          self.n_swap_outs)
        c("kvc_swap_ins_total", "KV images restored from the host pool",
          self.n_swap_ins)
        c("kvc_host_evictions_total", "host-pool images evicted to fit "
          "newer captures", self.n_host_evictions)
        g("kvc_host_pool_used_tokens", "host-pool tokens in use",
          self.host_used)
        g("kvc_host_pool_budget_tokens", "host-pool budget",
          self.host_pool_tokens)
        g("kvc_pending_shrink_blocks", "squeeze debt harvested as "
          "allocations free", self.pending_shrink)
        c("kvc_shrinks_total", "live capacity squeezes applied",
          self.n_shrinks)

    # ------------------------------------------------------------------ #
    def check_invariants(self) -> None:
        held = sum(a.blocks + a.reserve_blocks for a in self.allocs.values())
        assert self.free_blocks + held == self.total_blocks, \
            (self.free_blocks, held, self.total_blocks)
        res_held = sum(a.reserve_blocks for a in self.allocs.values())
        assert res_held == self.reserve_in_use, \
            (res_held, self.reserve_in_use)
        used_held = sum(a.used_tokens for a in self.allocs.values())
        assert used_held == self._used_tokens, \
            (used_held, self._used_tokens)
        assert 0 <= self.free_blocks <= self.total_blocks
        assert 0 <= self.reserve_in_use <= self.reserve_target
        for rid, a in self.allocs.items():
            assert a.used_tokens <= (a.blocks + a.reserve_blocks) \
                * self.block_size + a.lent_tokens, rid
        host_held = sum(e.tokens for e in self.swapped.values())
        assert host_held == self.host_used, (host_held, self.host_used)
        assert 0 <= self.host_used <= self.host_pool_tokens, \
            (self.host_used, self.host_pool_tokens)
        assert self.pending_shrink >= 0, self.pending_shrink
        assert self.total_blocks >= 0, self.total_blocks
