"""EconoServe scheduler family (§3) on a shared single-engine substrate.

``BaseScheduler`` owns the mechanics every policy shares: queues, the block
KVC, iteration bookkeeping (token generation, PT→GT transition, completion,
preemption). Policies override batch formation.

The EconoServe variants map to the paper's ablation:
  EconoServe-D    decoupled PT/GT queues, exact-allocation, iteration-level
  EconoServe-SD   + time-synced same-RL groups
  EconoServe-SDO  + Ordering
  EconoServe      + KVC pipelining  (the full system)
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .costmodel import CostModel
from .kvc import Allocation, BlockKVC, blocks_for
from .ordering import OrderedQueue, order_key, pick_fit, sort_queue
from .pipelining import PipeBook
from .predictor import DEFAULT_BUCKET, bucketize
from .request import Request, State


@dataclass
class IterationPlan:
    prompt_items: List[Tuple[Request, int]] = field(default_factory=list)
    decode_reqs: List[Request] = field(default_factory=list)
    sched_time: float = 0.0
    extra_time: float = 0.0        # swap-in/out, KV transfer, ...

    @property
    def prompt_tokens(self) -> int:
        return sum(c for _, c in self.prompt_items)

    @property
    def forward_size(self) -> int:
        return self.prompt_tokens + len(self.decode_reqs)

    @property
    def empty(self) -> bool:
        return not self.prompt_items and not self.decode_reqs


@dataclass
class Group:
    key: int                      # synced (padded) remaining RL at formation
    members: List[Request] = field(default_factory=list)
    age: int = 0                  # iterations since the group started


@dataclass
class SchedulerConfig:
    kvc_tokens: int = 14_336
    block_size: int = 32
    tfs: int = 2048
    max_model_len: int = 2048     # max RL for max-allocation policies
    reserve_frac: float = 0.03
    pad_ratio: float = 0.15
    buffer_frac: float = 0.15     # KVCPipe buffer b, fraction of RL
    bucket: int = DEFAULT_BUCKET
    max_batch_reqs: int = 512
    # feature toggles (ablation)
    sync_groups: bool = True
    ordering: bool = True
    pipelining: bool = True
    offload_free: bool = True     # preemption style for under-provision
    # incremental queue index (OrderedQueue) instead of per-iteration full
    # re-sorts; batch decisions are identical either way (tested) — False
    # keeps the reference path for determinism checks and benchmarks
    incremental_queues: bool = True
    # priority-index structure inside OrderedQueue: "skiplist" (O(log n)
    # insert/remove) or the legacy bisected "list" (O(n) memmove each);
    # decisions are bitwise identical either way (tested)
    queue_index: str = "skiplist"


class BaseScheduler:
    name = "base"

    def __init__(self, cfg: SchedulerConfig, cost: CostModel):
        self.cfg = cfg
        self.cost = cost
        self.kvc = BlockKVC(cfg.kvc_tokens, cfg.block_size, cfg.reserve_frac)
        self.pt_queue: List[Request] = []
        self.gt_queue: List[Request] = []
        self.running_groups: List[Group] = []
        self.current_plan: Optional[IterationPlan] = None
        self.completed: List[Request] = []
        # events/stats
        self.group_completed = True     # trigger initial GT fill
        self.n_preempt_swap = 0
        self.n_preempt_free = 0
        self.n_underprov = 0
        self.n_reserve_rescues = 0
        self.n_hosted = 0
        self.pending_extra_time = 0.0
        self.iter_completion_counts: List[int] = []
        # watermark-guard backpressure: queued GTs swapped out to host and
        # held out of admission until the guard releases pressure
        self.swap_hold: Dict[int, Request] = {}
        self.n_guard_swaps = 0
        # pressure-ladder rung 4: requests a capacity squeeze made
        # permanently inadmissible, cancelled by form_batch's deadlock
        # relief and parked here for the backend to surface terminally
        self.infeasible_shed: List[Request] = []
        self.n_infeasible_shed = 0
        # incrementally-maintained queue-minimum-demand heaps (lazy):
        # entries (value, rid); stale/changed entries are discarded or
        # re-keyed at query time. Only EconoServe with an OrderedQueue
        # maintains them (the only policy with a KVC certificate).
        self._track_gt_demand = False
        self._gt_need_heap: List[Tuple[int, int]] = []      # need blocks
        self._gt_need_res_heap: List[Tuple[int, int]] = []  # resident only
        self._gt_host_heap: List[Tuple[int, int]] = []      # remaining RL

    # ---------------------------------------------------------------- #
    def publish_metrics(self, registry, **labels) -> None:
        """Publish queue/preemption/pressure counters into a
        ``repro_torch.obs`` registry (names: ``scheduler_<noun>_<unit>``),
        then delegate the cache accounting to ``self.kvc``. One typed
        publication path shared by the engine sampler, the cluster
        backends and stall diagnostics."""
        ln = tuple(sorted(labels))

        def c(name, help, value, **extra):
            registry.counter(name, help, ln + tuple(sorted(extra))) \
                .labels(**labels, **extra).inc_to(value)

        def g(name, help, value, **extra):
            registry.gauge(name, help, ln + tuple(sorted(extra))) \
                .labels(**labels, **extra).set(value)

        g("scheduler_queue_depth", "requests waiting per queue",
          len(self.pt_queue), queue="pt")
        g("scheduler_queue_depth", "requests waiting per queue",
          len(self.gt_queue), queue="gt")
        g("scheduler_running_requests",
          "decode-phase requests in the current groups",
          sum(len(grp.members) for grp in self.running_groups))
        g("scheduler_running_groups", "time-synced RL groups",
          len(self.running_groups))
        g("scheduler_swap_hold_requests",
          "queued GTs held out of admission by the watermark guard",
          len(self.swap_hold))
        c("scheduler_completed_total", "requests completed",
          len(self.completed))
        c("scheduler_preemptions_total", "preemptions by style",
          self.n_preempt_swap, kind="swap")
        c("scheduler_preemptions_total", "preemptions by style",
          self.n_preempt_free, kind="free")
        c("scheduler_underprovision_total",
          "iterations that under-provisioned a group", self.n_underprov)
        c("scheduler_reserve_rescues_total",
          "PT admissions funded from the reserve set-aside",
          self.n_reserve_rescues)
        c("scheduler_hosted_total",
          "requests run inside lent KVC (KVCPipe)", self.n_hosted)
        c("scheduler_guard_swaps_total",
          "watermark-guard host swaps", self.n_guard_swaps)
        c("scheduler_infeasible_shed_total",
          "rung-4 permanently-inadmissible cancellations",
          self.n_infeasible_shed)
        self.kvc.publish_metrics(registry, **labels)

    # ---------------------------------------------------------------- #
    def on_arrival(self, req: Request, t: float) -> None:
        req.set_state(State.QUEUED_PT, t)
        self.pt_queue.append(req)

    @property
    def running_gts(self) -> List[Request]:
        return [m for g in self.running_groups for m in g.members]

    def has_work(self) -> bool:
        return bool(self.pt_queue or self.gt_queue or self.running_groups)

    # ---------------------------------------------------------------- #
    # shared mechanics
    # ---------------------------------------------------------------- #
    def _admit_pt(self, req: Request, t: float, use_reserve: bool = True) -> bool:
        """Allocate prompt KVC (exact) for a PT about to run. A probe that
        does not fit is a batching decision, not a runtime allocation
        failure (those are what Table 1 counts)."""
        need = req.prompt_len - self.kvc.allocated_tokens(req.rid)
        if need <= 0:
            return True
        if self.kvc.can_allocate(need):
            return self.kvc.allocate(req.rid, need)
        if use_reserve and self.kvc.allocate_reserve(
                req.rid, blocks_for(need, self.cfg.block_size)):
            return True
        return False

    def _grant_pt_capacity(self, req: Request, want: int,
                           allow_general: bool) -> int:
        """Allocate capacity for up to `want` more prompt tokens, block-
        granular, reserve first (the reserve exists to admit PTs, §3.3);
        the general pool is touched only when no GT is waiting for it —
        that is the resource-responsibility decoupling. Chunked prompts
        hold KVC only for processed chunks (§2.4 / fig 6)."""
        slack = self.kvc.allocated_tokens(req.rid) - req.prompt_done
        if slack >= want:
            return want
        need_blocks = blocks_for(want - slack, self.cfg.block_size)
        from_res = min(need_blocks, self.kvc.free_reserve)
        if from_res > 0:
            self.kvc.allocate_reserve(req.rid, from_res)
        if allow_general:
            from_gen = min(need_blocks - from_res, self.kvc.free_general)
            if from_gen > 0:
                self.kvc.extend(req.rid, from_gen)
        return min(want,
                   self.kvc.allocated_tokens(req.rid) - req.prompt_done)

    def _schedule_gt_member(self, req: Request, t: float) -> bool:
        """Exact-allocate the remaining padded RL for a GT (plus restoring
        prompt+generated KV space if it was swapped out)."""
        total = req.prompt_len + req.generated + req.remaining_predicted
        need = total - self.kvc.allocated_tokens(req.rid)
        if need > 0:
            # a GT with no live allocation (swapped out, or migrated in
            # from a peer instance) is a *new* concurrent request — the
            # same cap _fill_pts enforces bounds it, or an engine would
            # be asked for more slots than it has
            if req.rid not in self.kvc.allocs \
                    and len(self.kvc.allocs) >= self.cfg.max_batch_reqs:
                return False
            if not self.kvc.can_allocate(need):
                return False
            self.kvc.allocate(req.rid, need)
        # recycle the PT-admission reserve (§3.3: reserve is for adding PTs)
        self.kvc.release_reserve(req.rid)
        req.alloc_rl = req.generated + req.remaining_predicted
        self.kvc.set_used(req.rid, req.prompt_len + req.generated)
        req._run_start = req.generated
        req.set_state(State.RUNNING_GT, t)
        return True

    def _complete(self, req: Request, t: float) -> None:
        req.set_state(State.COMPLETED, t)
        req.t_complete = t
        self.kvc.free(req.rid)
        self.kvc.swap_release(req.rid)     # defensive: no image outlives it
        self.completed.append(req)

    def notify_eos(self, req: Request, at_generated: int) -> None:
        """The engine observed EOS at response token ``at_generated``
        (1-based count). Clamps the ground-truth RL so ``finish_iteration``
        completes the request. Tolerant of *lagged* delivery (an async
        engine may drain sampled tokens iterations after they were
        produced): clamping at or below tokens already accounted simply
        completes the request at the next ``finish_iteration`` — the
        completion check is ``generated >= true_rl``, not equality."""
        req.true_rl = min(req.true_rl, max(1, at_generated))

    def decode_horizon(self, plan: IterationPlan, max_k: int) -> int:
        """How many consecutive iterations (including the one just planned)
        are guaranteed to keep the decode-batch membership fixed — no
        admission, KVC allocation, under-provision, preemption, or
        pipelining event can fire before the horizon's last
        ``finish_iteration``. EOS-driven completions *inside* the horizon
        only ever shrink the batch when the queues are empty; under memory
        pressure (non-empty queues certified KVC-blocked by
        ``_admission_horizon``) an EOS completion frees KVC that could
        admit a waiter, so an engine fusing a pressure window must
        truncate it at the first EOS (``ServingEngine`` does — the device
        while_loop early-exits and the host replays only the iterations
        that ran).

        This is what lets an engine fuse K decode iterations into one
        device dispatch while the per-iteration scheduler replay stays
        bitwise-identical: events are provably absent from the window, so
        each replayed ``form_batch`` returns the same membership. The
        horizon may only ever *underestimate* (a shorter window is always
        correct, just slower).
        """
        if max_k <= 1 or plan.prompt_items or not plan.decode_reqs:
            return 1
        k = max_k
        if self.pt_queue or self.gt_queue:
            # non-empty queues: fuse only as far as the KVC-bound
            # no-admission certificate reaches (policies without one
            # certify nothing and fall back to per-iteration dispatch)
            k = min(k, self._admission_horizon(max_k))
        pipe = getattr(self, "pipe", None)
        if pipe is not None and pipe.active:
            # hosted-slot deadlines preempt at a *known* owner age — fuse
            # up to (not past) the earliest expiry
            k = min(k, self._pipe_expiry_horizon(pipe, max_k))
        if k <= 1:
            return 1
        for r in plan.decode_reqs:
            # completion at true_rl (EOS may land earlier: handled by the
            # replay); under-provision (rescue/preempt) at alloc_rl
            k = min(k, max(1, r.true_rl - r.generated),
                    max(1, r.alloc_rl - r.generated))
        return k

    def _admission_horizon(self, max_k: int) -> int:
        """Iterations (starting with the one just planned) during which
        provably nothing in the waiting queues can be admitted, assuming
        no completion / under-provision / pipelining event fires earlier
        (``decode_horizon`` bounds those separately). Base policies have
        no certificate: 1 (this iteration already admitted nothing)."""
        return 1

    def _pipe_expiry_horizon(self, pipe, max_k: int) -> int:
        """Iterations until the earliest hosted-slot deadline can fire.
        Base policies are conservative: 1 (the old always-bail rule)."""
        return 1

    def cancel(self, rid: int, t: float) -> Optional[Request]:
        """Remove a request from every scheduler structure — waiting
        queues, running groups — and free its KVC. Returns the detached
        ``Request`` (state ``ABORTED``), or None when the rid is unknown
        or already completed. This is the hook the engine's ``abort`` and
        the cluster's crash recovery lean on; policies with extra
        bookkeeping (KVC pipelining) override and extend it."""
        req = None
        for q in (self.pt_queue, self.gt_queue):
            for r in list(q):
                if r.rid == rid:
                    q.remove(r)
                    req = r
                    break
            if req is not None:
                break
        if req is None:
            for grp in self.running_groups:
                for m in grp.members:
                    if m.rid == rid:
                        grp.members.remove(m)
                        req = m
                        break
                if req is not None:
                    break
            if req is not None and any(not g.members
                                       for g in self.running_groups):
                self.running_groups = [g for g in self.running_groups
                                       if g.members]
                self.group_completed = True    # mirror finish_iteration
        if req is None:
            return None
        self.swap_hold.pop(rid, None)
        self.kvc.free(rid)
        self.kvc.swap_release(rid)         # drop any host-offloaded image
        req.set_state(State.ABORTED, t)
        return req

    def _pt_finished(self, req: Request, t: float) -> None:
        """Prompt fully processed → request becomes a queued GT. The PT
        iteration itself produces the first response token (§1)."""
        req.prompt_done = req.prompt_len
        if req.generated == 0:
            req.generated = 1
        req.occupied_kvc = req.prompt_len + req.generated
        self.kvc.set_used(req.rid, req.occupied_kvc)
        if req.t_first_token is None:
            req.t_first_token = t
        if req.done:
            self._complete(req, t)
            return
        req.set_state(State.QUEUED_GT, t)
        self.enqueue_gt(req)

    # ---------------------------------------------------------------- #
    # GT-queue chokepoint + incremental min-demand accounting
    # ---------------------------------------------------------------- #
    def _gt_need_blocks(self, r: Request) -> int:
        """Exact-allocation demand of a queued GT, in blocks — the quantity
        ``_schedule_gt_member`` tests against ``free_general``."""
        need = (r.prompt_len + r.generated + r.remaining_predicted) \
            - self.kvc.allocated_tokens(r.rid)
        return blocks_for(need, self.cfg.block_size)

    def enqueue_gt(self, req: Request) -> None:
        """Every GT enqueue goes through here so the min-demand heaps stay
        consistent with the queue. Policies without a KVC certificate skip
        the bookkeeping (``_track_gt_demand`` False)."""
        self.gt_queue.append(req)
        if self._track_gt_demand:
            self._push_gt_demand(req)

    def _push_gt_demand(self, req: Request) -> None:
        nb = self._gt_need_blocks(req)
        heapq.heappush(self._gt_need_heap, (nb, req.rid))
        if req.rid in self.kvc.allocs:
            heapq.heappush(self._gt_need_res_heap, (nb, req.rid))
        heapq.heappush(self._gt_host_heap,
                       (max(1, req.remaining_predicted), req.rid))

    def _heap_min(self, heap: List[Tuple[int, int]], value_fn,
                  resident_only: bool = False) -> Optional[int]:
        """Smallest current value over queued (non-held) GTs. Lazy: dead
        entries are popped, re-keyed entries re-pushed — each discard or
        re-key is paid for by the queue/demand event that caused it, so
        the certificate query is O(1) amortized instead of a queue scan."""
        while heap:
            val, rid = heap[0]
            r = self.gt_queue.get(rid)
            if r is None or rid in self.swap_hold \
                    or (resident_only and rid not in self.kvc.allocs):
                heapq.heappop(heap)
                continue
            cur = value_fn(r)
            if cur != val:
                heapq.heapreplace(heap, (cur, rid))
                continue
            return val
        return None

    def release_swap_holds(self) -> None:
        """Guard pressure released: held GTs rejoin the admission path
        (their swap-in leg is charged when the engine actually restores
        them). Re-pushes demand entries for still-queued holds — queries
        discarded their heap entries while held."""
        if self._track_gt_demand:
            for rid, req in self.swap_hold.items():
                if self.gt_queue.get(rid) is not None:
                    self._push_gt_demand(req)
        self.swap_hold.clear()

    # ---------------------------------------------------------------- #
    # to be provided by policies
    # ---------------------------------------------------------------- #
    def form_batch(self, t: float) -> IterationPlan:
        raise NotImplementedError

    def finish_iteration(self, t: float) -> None:
        raise NotImplementedError


# ------------------------------------------------------------------------- #
class EconoServeScheduler(BaseScheduler):
    """The full system; feature flags reproduce -D / -SD / -SDO."""
    def __init__(self, cfg: SchedulerConfig, cost: CostModel,
                 name: str = "econoserve"):
        super().__init__(cfg, cost)
        self.name = name
        self.pipe = PipeBook(buffer_tokens=0, min_size=cfg.block_size)
        self.zombies: Dict[int, List[Request]] = {}   # host rid -> children
        self.host_of: Dict[int, Request] = {}
        if cfg.ordering and cfg.incremental_queues:
            self.pt_queue = OrderedQueue(is_gt=False, index=cfg.queue_index)
            self.gt_queue = OrderedQueue(is_gt=True, index=cfg.queue_index)
            self._track_gt_demand = True

    @staticmethod
    def _age_of(req: Request) -> int:
        """Tokens the request has grown into its current allocation span."""
        return req.generated - getattr(req, "_run_start", 0)

    # -------------------------------------------------------------- #
    def _buffer_tokens(self, rl: int) -> int:
        return max(self.cfg.block_size,
                   int(math.ceil(rl * self.cfg.buffer_frac)))

    # -------------------------------------------------------------- #
    # pressure-proof megastep certificates (decode_horizon hooks)
    # -------------------------------------------------------------- #
    def _admission_horizon(self, max_k: int) -> int:
        """Conservative KVC-bound certificate: during a pure-decode window
        the KVC counters are frozen (exact allocation — ``used`` grows,
        ``allocated`` does not, and the caller excludes completion /
        under-provision / pipelining events from the window), so any
        admission blocker that is *independent of queue ordering* extends
        from "blocked now" to "blocked for the whole window". O(1) counter
        reads except the two explicitly-noted queue scans, which run once
        per window (not per iteration).

        Ordering-dependent outcomes (deadline buckets roll with t, so a
        different head may be picked at a later iteration) can never be
        certified — whenever free KVC could fund *any* pick we bail to 1.
        """
        kvc = self.kvc
        if self.pt_queue:
            # _fill_pts admits iff budget >= 1 AND kvc_avail >= 1 AND the
            # picked head is either resident (mid-chunk, exempt from the
            # concurrency cap) or under the cap. budget and residency are
            # frozen during the window; kvc_avail = reserve + (general
            # when no GT waits) is frozen too.
            budget = self.cfg.tfs - len(self.running_gts)
            if budget >= 1:
                fundable = kvc.free_reserve > 0 or (
                    not self.gt_queue and kvc.free_general > 0)
                if fundable:
                    if len(kvc.allocs) < self.cfg.max_batch_reqs:
                        return 1
                    # cap reached: only a resident (KVC-holding) PT can be
                    # granted; the pick is ordering-dependent, so any
                    # resident waiter voids the certificate (queue scan)
                    if any(kvc.allocated_tokens(r.rid) > 0
                           for r in self.pt_queue):
                        return 1
        if self.gt_queue:
            # _fill_gts admits a queued GT iff its exact-allocation demand
            # (prompt + generated + remaining_predicted - already-held,
            # all frozen while the GT waits) fits the general pool, and —
            # for GTs holding no allocation (swapped/migrated) — the
            # concurrency cap has room. Ordering only changes *which*
            # admissible candidate goes first, so "no candidate is
            # admissible" is t-independent and certifies the window
            # (queue scan, once per window)
            if kvc.free_general > 0:
                cap_full = len(kvc.allocs) >= self.cfg.max_batch_reqs
                if self._track_gt_demand:
                    # incremental min-demand counter: the cheapest queued
                    # demand is a heap peek (amortized O(1)), so the
                    # partially-free regime certifies without a queue scan
                    m = self._heap_min(
                        self._gt_need_res_heap if cap_full
                        else self._gt_need_heap,
                        self._gt_need_blocks, resident_only=cap_full)
                    if m is not None and m <= kvc.free_general:
                        return 1
                else:
                    for r in self.gt_queue:
                        if r.rid in self.swap_hold:
                            continue  # guard-held: fills skip it too
                        if cap_full and r.rid not in kvc.allocs:
                            continue  # _schedule_gt_member's cap rejects it
                        need = (r.prompt_len + r.generated
                                + r.remaining_predicted) \
                            - kvc.allocated_tokens(r.rid)
                        if blocks_for(need, self.cfg.block_size) \
                                <= kvc.free_general:
                            return 1
            if self.cfg.pipelining and self.pipe.open_slots:
                # hosted placement: open-slot capacity *shrinks* as owners
                # age (1 token/iteration) while queued demand is frozen,
                # so "cheapest demand exceeds the largest slot now"
                # certifies the whole window
                cap = self.pipe.max_hostable(self._age_of)
                if cap >= 1:
                    if self._track_gt_demand:
                        m = self._heap_min(
                            self._gt_host_heap,
                            lambda r: max(1, r.remaining_predicted))
                        if m is not None and m <= cap:
                            return 1
                    elif any(max(1, r.remaining_predicted) <= cap
                             for r in self.gt_queue
                             if r.rid not in self.swap_hold):
                        return 1
        return max_k

    def _pipe_expiry_horizon(self, pipe, max_k: int) -> int:
        """A hosted slot expires at the ``finish_iteration`` where its
        owner's run age reaches ``deadline_age`` — deterministic, so the
        window may extend through (not past) the earliest expiry.
        Completed (zombie) owners stop aging and never expire."""
        k = max_k
        for s in pipe.active:
            if s.child is None or s.owner.state != State.RUNNING_GT:
                continue
            k = min(k, max(1, s.deadline_age - self._age_of(s.owner)))
        return k

    def cancel(self, rid: int, t: float) -> Optional[Request]:
        """Cancel with KVC-pipelining bookkeeping: vacate the lent slot a
        hosted victim occupied, preempt children hosted inside the
        victim's span (their memory disappears with it), and release the
        host's zombie allocation when the victim was its last child."""
        req = super().cancel(rid, t)
        if req is None:
            return None
        self.pipe.release_child(req)
        host = self.host_of.pop(rid, None)
        orphans = self.pipe.drop_owner(req)
        for o in orphans:
            for g in self.running_groups:
                if o in g.members:
                    g.members.remove(o)
            self._preempt(o, t, offload_free=False)
        self.running_groups = [g for g in self.running_groups if g.members]
        if host is not None:
            self._maybe_free_zombie(host)
        return req

    def _sorted_gt_queue(self, t: float) -> List[Request]:
        if self.cfg.ordering:
            if isinstance(self.gt_queue, OrderedQueue):
                return self.gt_queue.sorted_view(t)
            return sort_queue(self.gt_queue, t, is_gt=True)
        return sorted(self.gt_queue, key=lambda r: r.arrival)

    def _sorted_pt_queue(self, t: float) -> List[Request]:
        if self.cfg.ordering:
            if isinstance(self.pt_queue, OrderedQueue):
                return self.pt_queue.sorted_view(t)
            return sort_queue(self.pt_queue, t, is_gt=False)
        return sorted(self.pt_queue, key=lambda r: r.arrival)

    # -------------------------------------------------------------- #
    def _fill_gts(self, t: float) -> int:
        """①: select GT groups (or single GTs) until KVC fully allocated."""
        n_sel = 0
        q = [r for r in self._sorted_gt_queue(t)
             if r.rid not in self.swap_hold]
        # remaining_predicted is constant within one _fill_gts call (it only
        # moves in finish_iteration), so the RL bucket of each candidate is
        # computed at most once per call instead of O(queue) per group
        buckets: Dict[int, int] = {}

        def rl_bucket(r: Request) -> int:
            b = buckets.get(r.rid)
            if b is None:
                b = bucketize(max(1, r.remaining_predicted), self.cfg.bucket)
                buckets[r.rid] = b
            return b

        while q:
            free_tok = self.kvc.free_tokens()
            if free_tok < self.cfg.block_size:
                break
            i = pick_fit(q, free_tok, t, is_gt=True) \
                if self.cfg.ordering else 0
            if i is None:
                i = 0
            head = q[i]
            if head.remaining_predicted > free_tok and not self.cfg.sync_groups:
                break
            if self.cfg.sync_groups:
                key = rl_bucket(head)
                same = [r for r in q if rl_bucket(r) == key]
                grp = Group(key=key)
                for r in same:
                    if r.remaining_predicted > self.kvc.free_tokens():
                        continue            # split the group to fit (§3.3.1)
                    if self._schedule_gt_member(r, t):
                        grp.members.append(r)
                        self.gt_queue.remove(r)
                        q.remove(r)
                        n_sel += 1
                        if self.cfg.pipelining:
                            self.pipe.buffer_tokens = self._buffer_tokens(key)
                            self.pipe.offer(r, r.remaining_predicted)
                if grp.members:
                    self.running_groups.append(grp)
                else:
                    break
            else:
                r = head
                if r.remaining_predicted > free_tok:
                    break
                if self._schedule_gt_member(r, t):
                    self.running_groups.append(Group(
                        key=bucketize(max(1, r.remaining_predicted),
                                      self.cfg.bucket), members=[r]))
                    self.gt_queue.remove(r)
                    q.remove(r)
                    n_sel += 1
                else:
                    break
        return n_sel

    def _fill_hosted(self, t: float) -> int:
        """②: KVC pipelining — place queued GTs into lent slots."""
        if not self.cfg.pipelining:
            return 0
        n_sel = 0
        q = [r for r in self._sorted_gt_queue(t)
             if r.rid not in self.swap_hold]
        while q and self.pipe.open_slots:
            cap = self.pipe.max_hostable(self._age_of)
            if cap < 1:
                break
            i = pick_fit(q, cap, t, is_gt=True)
            if i is None:
                break
            r = q[i]
            if r.rid not in self.kvc.allocs \
                    and len(self.kvc.allocs) >= self.cfg.max_batch_reqs:
                break                        # engine concurrency cap
            need = max(1, r.remaining_predicted)
            slot = self.pipe.place(r, need, self._age_of)
            if slot is None:
                break
            # hosted GTs draw no new KVC; register usage under their rid
            self.kvc.allocs.setdefault(r.rid, Allocation())
            self.kvc.allocs[r.rid].lent_tokens = need
            self.kvc.release_reserve(r.rid)   # left the PT phase
            r.alloc_rl = r.generated + need
            r._run_start = r.generated
            r.set_state(State.RUNNING_GT, t)
            self.host_of[r.rid] = slot.owner
            self.running_groups.append(Group(key=bucketize(need,
                                                           self.cfg.bucket),
                                             members=[r]))
            self.gt_queue.remove(r)
            q.remove(r)
            n_sel += 1
            self.n_hosted += 1
        return n_sel

    def _fill_pts(self, t: float) -> List[Tuple[Request, int]]:
        """③: add PTs (chunked if needed) until TFS is reached. KVC for a
        chunked prompt is allocated chunk-by-chunk; a prompt that cannot get
        capacity right now is skipped, not allowed to block the queue."""
        items: List[Tuple[Request, int]] = []
        budget = self.cfg.tfs - len(self.running_gts)
        allow_general = not self.gt_queue     # GTs own the general pool
        q = self._sorted_pt_queue(t)
        while q and budget >= 1:
            kvc_avail = self.kvc.free_reserve * self.cfg.block_size \
                + (self.kvc.free_tokens() if allow_general else 0)
            if kvc_avail < 1:
                break
            limit = min(budget, kvc_avail)
            i = pick_fit(q, limit, t, is_gt=False) \
                if self.cfg.ordering else 0
            if i is None:
                i = 0                        # no perfect fit → chunk the head
            r = q[i]
            # the concurrency cap bounds *new* admissions only: a chunked
            # prompt mid-flight already holds KVC (and an engine slot), so
            # continuing it adds no concurrent request — without this
            # exemption a full batch starves every in-flight chunked PT
            # until something completes. len(allocs) alone is the live
            # concurrency count: every grant (including ones made earlier
            # in this very loop) creates its alloc entry immediately.
            resident = self.kvc.allocated_tokens(r.rid) > 0
            if (not resident
                    and len(self.kvc.allocs) >= self.cfg.max_batch_reqs):
                break                        # engine concurrency cap
            remaining = r.prompt_len - r.prompt_done
            chunk = self._grant_pt_capacity(r, min(remaining, budget),
                                            allow_general)
            q.remove(r)
            if chunk <= 0:
                continue                     # cannot serve now; try others
            r.set_state(State.RUNNING_PT, t)
            if r.t_start_exec is None:
                r.t_start_exec = t
            items.append((r, chunk))
            self.pt_queue.remove(r)
            budget -= chunk
        return items

    # -------------------------------------------------------------- #
    def _evict_waiting(self, t: float, need_tokens: int) -> bool:
        """Deadlock relief: when nothing runs and nothing fits, swap out the
        lowest-priority *waiting* GTs' KV until `need_tokens` are free."""
        victims = list(reversed(self._sorted_gt_queue(t)))
        freed = False
        for v in victims:
            if self.kvc.free_tokens() >= need_tokens:
                break
            if self.kvc.allocated_tokens(v.rid) == 0:
                continue
            tokens = v.prompt_len + v.generated
            self.kvc.free(v.rid)
            self.pending_extra_time += 2 * self.cost.swap_time(tokens)
            v.swap_time += 2 * self.cost.swap_time(tokens)
            v.occupied_kvc = tokens        # held in host memory now
            v.prompt_done = v.prompt_len
            self.n_preempt_swap += 1
            freed = True
        return freed

    def fits_ever(self, tokens: int) -> bool:
        """Frozen-demand feasibility: would ``tokens`` of exact-alloc
        demand fit this scheduler's *empty* post-shrink cache? The rung-4
        shed uses the negation locally; the fleet's shed-retry tier asks
        it of every live peer to decide between a router-level re-route
        (someone can fund the demand) and a terminal shed (no one ever
        will)."""
        return blocks_for(tokens, self.cfg.block_size) \
            <= self.kvc.total_blocks - self.kvc.pending_shrink

    def _shed_infeasible(self, t: float) -> int:
        """Pressure-ladder rung 4: after a capacity squeeze, a queued
        request whose frozen admission demand exceeds what even an
        *empty* post-shrink cache can offer will never be admitted again
        — demand is frozen while it waits and capacity only shrinks.
        Called from form_batch's deadlock relief (nothing runs, nothing
        placeable, every softer rung exhausted): cancel the doomed
        requests and park them in ``infeasible_shed`` for the backend —
        which either surfaces them as terminal sheds or hands them back
        to the fleet's shed-retry tier for a re-route to a peer that can
        still fit them. Returns how many were cancelled."""
        doomed = [r for r in list(self.gt_queue)
                  if not self.fits_ever(r.prompt_len + r.generated
                                        + r.remaining_predicted)]
        doomed += [r for r in list(self.pt_queue)
                   if not self.fits_ever(r.prompt_len
                                         + max(r.padded_rl, 1))]
        for r in doomed:
            self.cancel(r.rid, t)
            self.infeasible_shed.append(r)
            self.n_infeasible_shed += 1
        return len(doomed)

    # -------------------------------------------------------------- #
    # watermark-guard backpressure (proactive host swap, rung 2)
    # -------------------------------------------------------------- #
    def swap_victims(self, max_n: Optional[int] = None) -> List[Request]:
        """Waiting GTs eligible for proactive swap-out, most-KVC-first —
        each victim releases the most device pressure (rid tie-break
        keeps victim choice deterministic)."""
        cands = [r for r in self.gt_queue
                 if r.rid not in self.swap_hold
                 and self.kvc.allocated_tokens(r.rid) > 0]
        cands.sort(key=lambda r: (-self.kvc.allocated_tokens(r.rid), r.rid))
        return cands if max_n is None else cands[:max_n]

    def guard_swap_out(self, req: Request, t: float) -> int:
        """Proactively swap a waiting GT's device KVC out (the engine
        captures the page image at its next slot sweep) and hold it out
        of admission until the guard releases pressure. Charges only the
        out leg — the in leg is charged at restore. Returns the token
        extent moved to host."""
        tokens = req.prompt_len + req.generated
        self.kvc.free(req.rid)
        out_t = self.cost.swap_out_time(tokens)
        self.pending_extra_time += out_t
        req.swap_time += out_t
        req.occupied_kvc = tokens          # held in host memory now
        req.prompt_done = req.prompt_len
        self.swap_hold[req.rid] = req
        self.n_guard_swaps += 1
        return tokens

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        n_gt_sel = 0
        # GT-side fill: Algorithm 1 gates this on group completion; we also
        # run it whenever queued GTs could be placed (free KVC or open lent
        # slots) — same policy, lower GT queuing delay (see DESIGN.md).
        if (self.group_completed or not self.running_groups
                or (self.gt_queue and
                    (self.kvc.free_tokens() >= self.cfg.block_size
                     or self.pipe.open_slots))):
            n_gt_sel += self._fill_gts(t)
            n_gt_sel += self._fill_hosted(t)
            self.group_completed = False
        if not self.running_groups and n_gt_sel == 0 and self.gt_queue:
            # liveness trumps backpressure: before deadlock relief, give
            # guard-held requests back to the admission path
            if self.swap_hold:
                self.release_swap_holds()
                n_gt_sel += self._fill_gts(t)
                n_gt_sel += self._fill_hosted(t)
        if not self.running_groups and n_gt_sel == 0 and self.gt_queue:
            head = self._sorted_gt_queue(t)[0]
            need = head.prompt_len + head.generated + head.remaining_predicted
            if self._evict_waiting(t, need):
                n_gt_sel += self._fill_gts(t)
                n_gt_sel += self._fill_hosted(t)
        if (not self.running_groups and n_gt_sel == 0
                and self.kvc.n_shrinks
                and (self.gt_queue or self.pt_queue)):
            # every softer rung failed and capacity has shrunk: shed what
            # can never fit again, then retry with the blocks it released
            if self._shed_infeasible(t):
                n_gt_sel += self._fill_gts(t)
                n_gt_sel += self._fill_hosted(t)
        plan.prompt_items = self._fill_pts(t)
        plan.decode_reqs = self.running_gts
        n_q = len(self.pt_queue) + len(self.gt_queue)
        if self.cfg.sync_groups:
            plan.sched_time = self.cost.sched_time_grouped(
                n_q, n_gt_sel + len(plan.prompt_items))
        else:
            plan.sched_time = self.cost.sched_time_fcfs(
                n_q, n_gt_sel + len(plan.prompt_items)) * 4
        plan.extra_time = self.pending_extra_time
        self.pending_extra_time = 0.0
        self.current_plan = plan
        return plan

    # -------------------------------------------------------------- #
    def _preempt(self, req: Request, t: float, offload_free: bool) -> None:
        req.n_preemptions += 1
        self.pipe.release_child(req)
        orphans = self.pipe.drop_owner(req)
        for o in orphans:
            self._preempt(o, t, offload_free=False)   # children swap out
        host = self.host_of.pop(req.rid, None)
        if offload_free:
            # drop KV — requeue as a PT that recomputes prompt + generated
            self.n_preempt_free += 1
            self.kvc.free(req.rid)
            req.occupied_kvc = 0
            req.prompt_done = 0
            req.set_state(State.PREEMPTED, t)
            self.pt_queue.append(req)
        else:
            # offload: KV moves to host memory; pay swap now + swap-in later
            self.n_preempt_swap += 1
            tokens = req.prompt_len + req.generated
            self.pending_extra_time += 2 * self.cost.swap_time(tokens)
            req.swap_time += 2 * self.cost.swap_time(tokens)
            self.kvc.free(req.rid)
            # the KV lives in host memory; the request still "occupies" it
            # for ordering purposes (O5: release it earlier)
            req.occupied_kvc = tokens
            req.prompt_done = req.prompt_len
            req.set_state(State.PREEMPTED, t)
            # re-prediction of the remaining length (§3.3.2)
            req.padded_rl = req.generated + bucketize(
                max(1, req.padded_rl - req.generated) + self.cfg.bucket,
                self.cfg.bucket)
            self.enqueue_gt(req)
        if host is not None:
            self._maybe_free_zombie(host)

    def _try_reserve_rescue(self, req: Request) -> bool:
        """① on under-provision: extend from the reserved KVC (O4)."""
        if req.hosted:
            return False                 # lent space cannot be extended
        if not self.kvc.allocate_reserve(req.rid, 1):
            return False
        self.n_reserve_rescues += 1
        req.alloc_rl += self.cfg.block_size
        req.padded_rl = req.alloc_rl
        return True

    def _handle_underprovision(self, req: Request, t: float) -> None:
        """② no reserve left (or hosted): preempt (offload-free by default)."""
        if req.hosted or not self.cfg.offload_free:
            self._preempt(req, t, offload_free=False)
        else:
            self._preempt(req, t, offload_free=True)
        # requeued with a fresh remaining estimate (L_new, §3.3.2); the
        # offload-free path re-prefills, the swap path set L_new in _preempt
        if req.prompt_done == 0:
            req.padded_rl = req.generated + bucketize(
                self.cfg.bucket, self.cfg.bucket)

    def finish_iteration(self, t: float) -> None:
        plan = self.current_plan
        assert plan is not None
        n_completed = 0
        # ---- PTs -----------------------------------------------------
        for req, chunk in plan.prompt_items:
            req.prompt_done += chunk
            req.occupied_kvc = req.prompt_done + req.generated
            self.kvc.set_used(req.rid, req.occupied_kvc)
            if req.prompt_done >= req.prompt_len:
                self._pt_finished(req, t)
            else:
                req.set_state(State.QUEUED_PT, t)
                self.pt_queue.append(req)      # chunked prompt continues
        # ---- GTs -----------------------------------------------------
        for grp in list(self.running_groups):
            grp.age += 1
            for m in list(grp.members):
                m.generated += 1
                m.occupied_kvc = m.prompt_len + m.generated
                self.kvc.add_used(m.rid, 1)
                if m.t_first_token is None:
                    m.t_first_token = t
                if m.done:
                    grp.members.remove(m)
                    self._finish_member(m, t)
                    n_completed += 1
                elif m.generated >= m.alloc_rl:
                    self.n_underprov += 1
                    if not self._try_reserve_rescue(m):
                        grp.members.remove(m)
                        self._handle_underprovision(m, t)
            if not grp.members:
                self.running_groups.remove(grp)
                self.group_completed = True
        # ---- KVCPipe deadline enforcement -----------------------------
        expired = self.pipe.expired(self._age_of)
        for slot in expired:
            child = slot.child
            self.pipe.release_child(child)
            for g in self.running_groups:
                if child in g.members:
                    g.members.remove(child)
            self._preempt(child, t, offload_free=False)
        self.running_groups = [g for g in self.running_groups if g.members]
        self.iter_completion_counts.append(n_completed)

    def _finish_member(self, m: Request, t: float) -> None:
        """Completion honoring zombie (lent-space) semantics."""
        self.pipe.release_child(m)
        host = self.host_of.pop(m.rid, None)
        if host is not None:
            # hosted GT: its RL KV lived in the host's span (lent), but its
            # own prompt blocks are real — free them normally
            self._complete(m, t)
            self._maybe_free_zombie(host)
            return
        children = [s.child for s in self.pipe.active
                    if s.owner is m and s.child is not None]
        if children:
            # defer the free until hosted children vacate
            self.zombies[m.rid] = children
            m.set_state(State.COMPLETED, t)
            m.t_complete = t
            self.completed.append(m)
            self.pipe.open_slots = [s for s in self.pipe.open_slots
                                    if s.owner is not m]
        else:
            self.pipe.drop_owner(m)
            self._complete(m, t)

    def _maybe_free_zombie(self, host: Request) -> None:
        if host.rid in self.zombies:
            kids = [c for c in self.zombies[host.rid]
                    if c.state == State.RUNNING_GT]
            if not kids:
                del self.zombies[host.rid]
                self.kvc.free(host.rid)


def make_econoserve(cfg: SchedulerConfig, cost: CostModel,
                    variant: str = "full") -> EconoServeScheduler:
    """variant ∈ {'d', 'sd', 'sdo', 'full', 'oracle'} (ablation §4)."""
    import dataclasses
    flags = {
        "d": dict(sync_groups=False, ordering=False, pipelining=False),
        "sd": dict(sync_groups=True, ordering=False, pipelining=False),
        "sdo": dict(sync_groups=True, ordering=True, pipelining=False),
        "full": dict(sync_groups=True, ordering=True, pipelining=True),
        "oracle": dict(sync_groups=True, ordering=True, pipelining=True),
    }[variant]
    cfg = dataclasses.replace(cfg, **flags)
    names = {"d": "econoserve-d", "sd": "econoserve-sd",
             "sdo": "econoserve-sdo", "full": "econoserve",
             "oracle": "oracle"}
    return EconoServeScheduler(cfg, cost, name=names[variant])
