"""Every scheduler the paper compares against (§2, §4), on the shared
BaseScheduler substrate:

  ORCA          iteration-level FCFS, max-allocation, fixed batch size
  SRTF          shortest-remaining-time-first, max-allocation
  FastServe     5-level MLFQ (skip-join), max-allocation
  vLLM          FCFS + block-allocation + swap-based preemption
  Sarathi-Serve chunked prefill to TFS + block-allocation
  MultiRes      dual-resource Euclidean matching, exact-allocation (O(n^2))
  SyncCoupled   MultiRes + same-RL GT groups
  DistServe     disaggregated prefill/decode engines + KV transfer
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .costmodel import CostModel
from .kvc import blocks_for
from .metrics import IterSample, SimResult
from .predictor import bucketize
from .request import Request, State
from .scheduler import BaseScheduler, IterationPlan, SchedulerConfig


# ------------------------------------------------------------------------- #
class OrcaScheduler(BaseScheduler):
    """Iteration-level FCFS with max-allocation [11]."""
    name = "orca"

    def __init__(self, cfg: SchedulerConfig, cost: CostModel,
                 batch_size: int = 8):
        super().__init__(cfg, cost)
        self.batch_size = batch_size
        self.running: List[Request] = []

    def has_work(self) -> bool:
        return bool(self.pt_queue or self.running)

    def _max_alloc(self, req: Request) -> int:
        return req.prompt_len + self.cfg.max_model_len

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        n_sel = 0
        q = sorted(self.pt_queue, key=lambda r: r.arrival)
        for r in q:
            if len(self.running) + len(plan.prompt_items) >= self.batch_size:
                break
            need = self._max_alloc(r)
            if not self.kvc.can_allocate(need):
                break                      # FCFS head-of-line on KVC
            self.kvc.allocate(r.rid, need)
            r.alloc_rl = self.cfg.max_model_len
            r.set_state(State.RUNNING_PT, t)
            if r.t_start_exec is None:
                r.t_start_exec = t
            plan.prompt_items.append((r, r.prompt_len))
            self.pt_queue.remove(r)
            n_sel += 1
        plan.decode_reqs = list(self.running)
        plan.sched_time = self.cost.sched_time_fcfs(
            len(self.pt_queue), n_sel)
        self.current_plan = plan
        return plan

    def finish_iteration(self, t: float) -> None:
        plan = self.current_plan
        n_done = 0
        for r, _ in plan.prompt_items:
            r.prompt_done = r.prompt_len
            self.kvc.set_used(r.rid, r.prompt_len)
            if r.t_first_token is None:
                r.t_first_token = t
            r.set_state(State.RUNNING_GT, t)
            self.running.append(r)
        for r in list(self.running):
            if r.state != State.RUNNING_GT:
                continue
            if r in [p for p, _ in plan.prompt_items]:
                continue                   # prefilled this iteration
            r.generated += 1
            self.kvc.add_used(r.rid, 1)
            if r.done:
                self.running.remove(r)
                self._complete(r, t)
                n_done += 1
        self.iter_completion_counts.append(n_done)


# ------------------------------------------------------------------------- #
class SRTFScheduler(OrcaScheduler):
    """Shortest-remaining-time-first (known RL), max-allocation."""
    name = "srtf"

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        # preemptive: keep only the shortest-remaining `batch_size` running
        pool = self.running + [r for r in self.pt_queue]
        pool.sort(key=lambda r: r.true_rl - r.generated)
        chosen = []
        for r in pool:
            if len(chosen) >= self.batch_size:
                break
            if r.state in (State.RUNNING_GT, State.PREEMPTED) \
                    and r.prompt_done >= r.prompt_len:
                chosen.append(r)
            else:  # needs admission (max-alloc) + prefill
                need = self._max_alloc(r)
                if self.kvc.allocated_tokens(r.rid) >= need or \
                        self.kvc.can_allocate(need - self.kvc.allocated_tokens(r.rid)):
                    if self.kvc.allocated_tokens(r.rid) < need:
                        self.kvc.allocate(r.rid, need - self.kvc.allocated_tokens(r.rid))
                    r.alloc_rl = self.cfg.max_model_len
                    if r.t_start_exec is None:
                        r.t_start_exec = t
                    r.set_state(State.RUNNING_PT, t)
                    plan.prompt_items.append((r, r.prompt_len))
                    if r in self.pt_queue:
                        self.pt_queue.remove(r)
                    chosen.append(r)
        # displaced runners pause but keep their (max) allocation
        for r in self.running:
            if r not in chosen:
                r.set_state(State.PREEMPTED, t)
                r.n_preemptions += 1
                self.pt_queue.append(r)
        self.running = [r for r in chosen
                        if r.state in (State.RUNNING_GT, State.PREEMPTED)]
        for r in self.running:
            r.set_state(State.RUNNING_GT, t)
        plan.decode_reqs = list(self.running)
        plan.sched_time = self.cost.sched_time_fcfs(len(self.pt_queue),
                                                    len(chosen)) * 2
        self.current_plan = plan
        return plan


# ------------------------------------------------------------------------- #
class FastServeScheduler(BaseScheduler):
    """MLFQ with skip-join [12]; max-allocation."""
    name = "fastserve"

    def __init__(self, cfg: SchedulerConfig, cost: CostModel,
                 levels: int = 5, base_quantum: int = 2,
                 batch_size: int = 8):
        super().__init__(cfg, cost)
        self.levels = [[] for _ in range(levels)]
        self.quanta = [base_quantum * (2 ** i) for i in range(levels)]
        self.batch_size = batch_size
        self.running: List[Tuple[Request, int]] = []   # (req, level)
        self.used_quantum: dict = {}

    def has_work(self) -> bool:
        return bool(self.running or any(self.levels) or self.pt_queue)

    def on_arrival(self, req: Request, t: float) -> None:
        req.set_state(State.QUEUED_PT, t)
        # skip-join: longer prompts start at lower priority
        lvl = min(len(self.levels) - 1,
                  int(math.log2(max(1, req.prompt_len // 64)) + 1)
                  if req.prompt_len > 64 else 0)
        self.levels[lvl].append(req)

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        chosen: List[Tuple[Request, int]] = []
        # keep running requests that still have quantum at their level,
        # preferring higher-priority levels
        pool = sorted(self.running, key=lambda rl: rl[1])
        for lvl_i, level in enumerate(self.levels):
            for r in sorted(level, key=lambda r: r.arrival):
                pool.append((r, lvl_i))
        for r, lvl in pool:
            if len(chosen) >= self.batch_size:
                break
            if r.prompt_done < r.prompt_len:
                need = r.prompt_len + self.cfg.max_model_len \
                    - self.kvc.allocated_tokens(r.rid)
                if need > 0 and not self.kvc.can_allocate(need):
                    continue
                if need > 0:
                    self.kvc.allocate(r.rid, need)
                r.alloc_rl = self.cfg.max_model_len
                if r.t_start_exec is None:
                    r.t_start_exec = t
                r.set_state(State.RUNNING_PT, t)
                plan.prompt_items.append((r, r.prompt_len))
            else:
                r.set_state(State.RUNNING_GT, t)
            chosen.append((r, lvl))
            if r in self.levels[lvl]:
                self.levels[lvl].remove(r)
        # displaced
        for r, lvl in self.running:
            if all(r is not c for c, _ in chosen):
                r.set_state(State.PREEMPTED, t)
                r.n_preemptions += 1
                self.levels[lvl].append(r)
        self.running = chosen
        plan.decode_reqs = [r for r, _ in chosen
                            if r.prompt_done >= r.prompt_len]
        n_q = sum(len(l) for l in self.levels)
        plan.sched_time = self.cost.sched_time_mlfq(n_q, len(chosen))
        self.current_plan = plan
        return plan

    def finish_iteration(self, t: float) -> None:
        plan = self.current_plan
        n_done = 0
        nxt: List[Tuple[Request, int]] = []
        for r, lvl in self.running:
            if r.prompt_done < r.prompt_len:
                r.prompt_done = r.prompt_len
                self.kvc.set_used(r.rid, r.prompt_len)
                if r.t_first_token is None:
                    r.t_first_token = t
            else:
                r.generated += 1
                self.kvc.add_used(r.rid, 1)
            self.used_quantum[r.rid] = self.used_quantum.get(r.rid, 0) + 1
            if r.done:
                self._complete(r, t)
                n_done += 1
                continue
            if self.used_quantum[r.rid] >= self.quanta[lvl] \
                    and lvl < len(self.levels) - 1:
                # demote (keeps allocation — the KVC bottleneck of MLFQ)
                self.used_quantum[r.rid] = 0
                r.set_state(State.PREEMPTED, t)
                r.n_preemptions += 1
                self.levels[lvl + 1].append(r)
            else:
                nxt.append((r, lvl))
        self.running = nxt
        self.iter_completion_counts.append(n_done)


# ------------------------------------------------------------------------- #
class VLLMScheduler(BaseScheduler):
    """FCFS + block-allocation + swap-based preemption [13]."""
    name = "vllm"
    recompute_on_preempt = False

    def __init__(self, cfg: SchedulerConfig, cost: CostModel,
                 max_num_seqs: int = 256, watermark_blocks: int = 2):
        super().__init__(cfg, cost)
        self.running: List[Request] = []
        self.swapped: List[Request] = []
        self.max_num_seqs = max_num_seqs
        self.watermark = watermark_blocks

    def has_work(self) -> bool:
        return bool(self.pt_queue or self.swapped or self.running)

    # -------------------------------------------------------------- #
    def _admit_blocks(self, req: Request, tokens: int) -> bool:
        need_blocks = blocks_for(tokens, self.cfg.block_size) \
            - blocks_for(self.kvc.allocated_tokens(req.rid),
                         self.cfg.block_size)
        if need_blocks <= 0:
            return True
        if self.kvc.free_general - need_blocks < self.watermark:
            return False
        return self.kvc.extend(req.rid, need_blocks)

    def _resume_swapped(self, plan: IterationPlan, t: float) -> None:
        """vLLM's scheduler preserves FCFS — the oldest swapped group is
        resumed eagerly, preempting *newer* running groups if needed. Under
        KVC pressure this is the swap thrash the paper measures (74% / 67%
        allocation-failure rates for vLLM / Sarathi-Serve, fig 1d)."""
        for r in sorted(self.swapped, key=lambda r: r.arrival):
            tokens = r.prompt_len + r.generated + 1
            if len(self.running) >= self.max_num_seqs:
                break
            while not self._admit_blocks(r, tokens):
                newer = [v for v in self.running
                         if v.state == State.RUNNING_GT
                         and v.arrival > r.arrival]
                if not newer:
                    break
                victim = max(newer, key=lambda v: v.arrival)
                self.running.remove(victim)
                victim.n_preemptions += 1
                self.n_preempt_swap += 1
                vt = victim.prompt_len + victim.generated
                self.kvc.free(victim.rid)
                plan.extra_time += self.cost.swap_time(vt)
                victim.swap_time += self.cost.swap_time(vt)
                victim.set_state(State.PREEMPTED, t)
                self.swapped.append(victim)
            if self.kvc.allocated_tokens(r.rid) >= tokens:
                self.swapped.remove(r)
                self.kvc.set_used(r.rid, tokens - 1)
                plan.extra_time += self.cost.swap_time(tokens - 1)
                r.swap_time += self.cost.swap_time(tokens - 1)
                r.set_state(State.RUNNING_GT, t)
                self.running.append(r)
            else:
                break

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        self._resume_swapped(plan, t)
        n_new = 0
        for r in sorted(self.pt_queue, key=lambda r: r.arrival):
            if len(self.running) >= self.max_num_seqs:
                break
            if not self._admit_blocks(r, r.prompt_len + 1):
                break                        # FCFS head blocks
            if r.t_start_exec is None:
                r.t_start_exec = t
            r.set_state(State.RUNNING_PT, t)
            plan.prompt_items.append((r, r.prompt_len))
            self.pt_queue.remove(r)
            self.running.append(r)
            n_new += 1
        plan.decode_reqs = [r for r in self.running
                            if r.state == State.RUNNING_GT]
        plan.sched_time = self.cost.sched_time_fcfs(
            len(self.pt_queue) + len(self.swapped), n_new)
        self.current_plan = plan
        return plan

    def _preempt_victim(self, t: float) -> bool:
        """Swap out (or recompute-drop) the most recent running request."""
        gts = [r for r in self.running if r.state == State.RUNNING_GT]
        if not gts:
            return False
        victim = max(gts, key=lambda r: r.arrival)
        self.running.remove(victim)
        victim.n_preemptions += 1
        tokens = victim.prompt_len + victim.generated
        self.kvc.free(victim.rid)
        if self.recompute_on_preempt:
            self.n_preempt_free += 1
            victim.prompt_done = 0
            victim.occupied_kvc = 0
            victim.set_state(State.PREEMPTED, t)
            self.pt_queue.append(victim)
        else:
            self.n_preempt_swap += 1
            self.pending_extra_time += self.cost.swap_time(tokens)
            victim.swap_time += self.cost.swap_time(tokens)
            victim.set_state(State.PREEMPTED, t)
            self.swapped.append(victim)
        return True

    def finish_iteration(self, t: float) -> None:
        plan = self.current_plan
        n_done = 0
        for r, _ in plan.prompt_items:
            r.prompt_done = r.prompt_len
            self.kvc.set_used(r.rid, r.prompt_len)
            if r.t_first_token is None:
                r.t_first_token = t
            r.set_state(State.RUNNING_GT, t)
        for r in list(self.running):
            if r.state != State.RUNNING_GT:
                continue
            if any(r is p for p, _ in plan.prompt_items):
                continue
            # need one more token of space?
            tokens = r.prompt_len + r.generated + 1
            while tokens > self.kvc.allocated_tokens(r.rid):
                if not self.kvc.extend(r.rid, 1):
                    if not self._preempt_victim(t):
                        break
                    if r not in self.running:      # preempted itself
                        break
            if r not in self.running or r.state != State.RUNNING_GT:
                continue
            if tokens > self.kvc.allocated_tokens(r.rid):
                continue                           # could not grow: stall
            r.generated += 1
            self.kvc.add_used(r.rid, 1)
            if r.done:
                self.running.remove(r)
                self._complete(r, t)
                n_done += 1
        self.iter_completion_counts.append(n_done)


# ------------------------------------------------------------------------- #
class SarathiScheduler(VLLMScheduler):
    """Chunked prefill to the target forward size [15]."""
    name = "sarathi"

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        self._resume_swapped(plan, t)
        budget = self.cfg.tfs - len([r for r in self.running
                                     if r.state == State.RUNNING_GT])
        n_new = 0
        # continue partially prefilled first, then admit new
        partial = [r for r in self.running if r.prompt_done < r.prompt_len]
        newq = sorted(self.pt_queue, key=lambda r: r.arrival)
        for r in partial + newq:
            if budget <= 0 or len(self.running) >= self.max_num_seqs:
                break
            chunk = min(budget, r.prompt_len - r.prompt_done)
            if chunk <= 0:
                continue
            if not self._admit_blocks(r, r.prompt_done + chunk):
                break
            if r in self.pt_queue:
                self.pt_queue.remove(r)
                self.running.append(r)
                n_new += 1
            if r.t_start_exec is None:
                r.t_start_exec = t
            r.set_state(State.RUNNING_PT, t)
            plan.prompt_items.append((r, chunk))
            budget -= chunk
        plan.decode_reqs = [r for r in self.running
                            if r.state == State.RUNNING_GT]
        plan.sched_time = self.cost.sched_time_fcfs(
            len(self.pt_queue) + len(self.swapped), n_new) * 1.8
        self.current_plan = plan
        return plan

    def finish_iteration(self, t: float) -> None:
        plan = self.current_plan
        n_done = 0
        for r, chunk in plan.prompt_items:
            r.prompt_done += chunk
            self.kvc.set_used(r.rid, r.prompt_done)
            if r.prompt_done >= r.prompt_len:
                if r.t_first_token is None:
                    r.t_first_token = t
                r.set_state(State.RUNNING_GT, t)
        for r in list(self.running):
            if r.state != State.RUNNING_GT:
                continue
            if any(r is p for p, _ in plan.prompt_items):
                continue
            tokens = r.prompt_len + r.generated + 1
            while tokens > self.kvc.allocated_tokens(r.rid):
                if not self.kvc.extend(r.rid, 1):
                    if not self._preempt_victim(t):
                        break
                    if r not in self.running:
                        break
            if r not in self.running or r.state != State.RUNNING_GT:
                continue
            if tokens > self.kvc.allocated_tokens(r.rid):
                continue
            r.generated += 1
            self.kvc.add_used(r.rid, 1)
            if r.done:
                self.running.remove(r)
                self._complete(r, t)
                n_done += 1
        self.iter_completion_counts.append(n_done)


# ------------------------------------------------------------------------- #
class MultiResScheduler(BaseScheduler):
    """Dual-resource Euclidean matching (UnsyncCoupled) [32]-style."""
    name = "multires"
    sync_groups = False

    def __init__(self, cfg: SchedulerConfig, cost: CostModel):
        super().__init__(cfg, cost)
        self.running: List[Request] = []

    def has_work(self) -> bool:
        return bool(self.pt_queue or self.gt_queue or self.running)

    def _demand(self, r: Request) -> Tuple[float, float]:
        if r.prompt_done < r.prompt_len:
            gpu = r.prompt_len - r.prompt_done
            kvc = r.prompt_len + r.remaining_predicted \
                - self.kvc.allocated_tokens(r.rid)
        else:
            gpu = 1.0
            kvc = (r.prompt_len + r.generated + r.remaining_predicted
                   - self.kvc.allocated_tokens(r.rid))
        return float(gpu), float(max(0, kvc))

    def form_batch(self, t: float) -> IterationPlan:
        plan = IterationPlan()
        candidates = self.pt_queue + self.gt_queue
        if self.sync_groups:
            plan.sched_time = self.cost.sched_time_grouped(
                len(candidates), 1)
        else:
            plan.sched_time = self.cost.sched_time_quadratic(
                len(candidates), 1)
        n_sel = 0
        while candidates:
            gpu_avail = float(self.cfg.tfs - len(self.running)
                              - plan.prompt_tokens)
            kvc_avail = float(self.kvc.free_tokens())
            if gpu_avail <= 0 and kvc_avail <= 0:
                break
            feasible = []
            for r in candidates:
                g, k = self._demand(r)
                if g <= max(gpu_avail, 1) and k <= kvc_avail:
                    d = math.hypot((gpu_avail - g) / max(1, self.cfg.tfs),
                                   (kvc_avail - k) /
                                   max(1, self.kvc.capacity_tokens))
                    feasible.append((d, r.rid, r))
            if not feasible:
                break
            if self.sync_groups and feasible:
                # grouped selection: take the best AND its same-RL peers
                _, _, best = min(feasible)
                picks = [best]
                if best.prompt_done >= best.prompt_len:
                    key = bucketize(max(1, best.remaining_predicted),
                                    self.cfg.bucket)
                    for _, _, r in sorted(feasible):
                        if r is not best and r.prompt_done >= r.prompt_len \
                            and bucketize(max(1, r.remaining_predicted),
                                          self.cfg.bucket) == key:
                            picks.append(r)
            else:
                _, _, best = min(feasible)
                picks = [best]
            for r in picks:
                g, k = self._demand(r)
                if k > self.kvc.free_tokens():
                    continue
                if k > 0:
                    self.kvc.allocate(r.rid, int(k))
                r.alloc_rl = r.generated + r.remaining_predicted
                candidates.remove(r)
                n_sel += 1
                if r.prompt_done < r.prompt_len:
                    if r.t_start_exec is None:
                        r.t_start_exec = t
                    r.set_state(State.RUNNING_PT, t)
                    plan.prompt_items.append(
                        (r, r.prompt_len - r.prompt_done))
                    self.pt_queue.remove(r)
                else:
                    r.set_state(State.RUNNING_GT, t)
                    r._run_start = r.generated
                    self.gt_queue.remove(r)
                    self.running.append(r)
        plan.decode_reqs = [r for r in self.running
                            if r.state == State.RUNNING_GT]
        self.current_plan = plan
        return plan

    def finish_iteration(self, t: float) -> None:
        plan = self.current_plan
        n_done = 0
        for r, chunk in plan.prompt_items:
            r.prompt_done += chunk
            self.kvc.set_used(r.rid, r.prompt_done)
            if r.prompt_done >= r.prompt_len:
                if r.t_first_token is None:
                    r.t_first_token = t
                r.set_state(State.RUNNING_GT, t)
                self.running.append(r)
            else:
                r.set_state(State.QUEUED_PT, t)
                self.pt_queue.append(r)
        for r in list(self.running):
            if r.state != State.RUNNING_GT:
                continue
            if any(r is p for p, _ in plan.prompt_items):
                continue
            r.generated += 1
            self.kvc.add_used(r.rid, 1)
            if r.done:
                self.running.remove(r)
                self._complete(r, t)
                n_done += 1
            elif r.generated >= r.alloc_rl:
                # under-provision without reserve: swap-based preemption
                self.n_underprov += 1
                self.running.remove(r)
                r.n_preemptions += 1
                self.n_preempt_swap += 1
                tokens = r.prompt_len + r.generated
                self.pending_extra_time += 2 * self.cost.swap_time(tokens)
                r.swap_time += 2 * self.cost.swap_time(tokens)
                self.kvc.free(r.rid)
                r.occupied_kvc = tokens
                r.padded_rl = r.generated + bucketize(
                    self.cfg.bucket, self.cfg.bucket)
                r.set_state(State.PREEMPTED, t)
                self.gt_queue.append(r)
        self.iter_completion_counts.append(n_done)


class SyncCoupledScheduler(MultiResScheduler):
    name = "synccoupled"
    sync_groups = True


# ------------------------------------------------------------------------- #
# DistServe: disaggregated prefill / decode engines
# ------------------------------------------------------------------------- #
def simulate_distserve(requests, cfg: SchedulerConfig, cost: CostModel,
                       max_iters: int = 2_000_000) -> SimResult:
    """Two engines (prefill / decode) with a KV transfer in between.
    Each engine has its own KVC of cfg.kvc_tokens (2x GPUs total)."""
    from .kvc import BlockKVC

    reqs = sorted(requests, key=lambda r: r.arrival)
    n = len(reqs)
    i_arr = 0
    tP = tD = 0.0
    pq: List[Request] = []               # prefill queue
    dq: List[Tuple[float, Request]] = []  # (ready time at decode, req)
    running_d: List[Request] = []
    kvc_p = BlockKVC(cfg.kvc_tokens, cfg.block_size)
    kvc_d = BlockKVC(cfg.kvc_tokens, cfg.block_size)
    samples: List[IterSample] = []
    completed = 0
    iters = 0

    while iters < max_iters and completed < n:
        iters += 1
        t = min(tP, tD)
        while i_arr < n and reqs[i_arr].arrival <= max(tP, tD):
            r = reqs[i_arr]
            r.set_state(State.QUEUED_PT, r.arrival)
            pq.append(r)
            i_arr += 1
        progressed = False
        # ---- prefill engine ------------------------------------------
        if tP <= tD or not running_d:
            batch = []
            budget = cfg.tfs
            for r in sorted(pq, key=lambda r: r.arrival):
                if r.arrival > tP or budget < r.prompt_len:
                    continue
                if not kvc_p.can_allocate(r.prompt_len):
                    break
                kvc_p.allocate(r.rid, r.prompt_len)
                batch.append(r)
                budget -= r.prompt_len
            if batch:
                progressed = True
                dt = cost.iteration_time(sum(r.prompt_len for r in batch), [])
                tP += dt + cost.sched_time_fcfs(len(pq), len(batch))
                for r in batch:
                    pq.remove(r)
                    r.prompt_done = r.prompt_len
                    if r.t_start_exec is None:
                        r.t_start_exec = tP
                    if r.t_first_token is None:
                        r.t_first_token = tP
                    kvc_p.free(r.rid)
                    xfer = cost.kv_transfer_time(r.prompt_len)
                    r.swap_time += xfer
                    r.charge(tP)
                    dq.append((tP + xfer, r))
            elif i_arr < n and not running_d and not dq:
                tP = max(tP, reqs[i_arr].arrival)
                continue
            else:
                tP = max(tP, tD)          # idle prefill engine
        # ---- decode engine -------------------------------------------
        ready = [r for (rt, r) in dq if rt <= tD]
        for r in ready:
            tokens = r.prompt_len + r.generated + 1
            if not kvc_d.can_allocate(tokens):
                break
            kvc_d.allocate(r.rid, tokens)
            kvc_d.set_used(r.rid, tokens - 1)
            r.set_state(State.RUNNING_GT, tD)
            dq[:] = [(rt, x) for (rt, x) in dq if x is not r]
            running_d.append(r)
        if running_d:
            progressed = True
            ctxs = [r.prompt_len + r.generated for r in running_d]
            dt = cost.iteration_time(0, ctxs)
            tD += dt
            n_done = 0
            for r in list(running_d):
                tokens = r.prompt_len + r.generated + 1
                if tokens > kvc_d.allocated_tokens(r.rid):
                    while not kvc_d.extend(r.rid, 1):
                        # evict the newest running request (swap to host,
                        # re-admit later) — prevents a full-KVC stall
                        newer = [v for v in running_d
                                 if v.arrival > r.arrival and v is not r]
                        if not newer:
                            break
                        victim = max(newer, key=lambda v: v.arrival)
                        running_d.remove(victim)
                        victim.n_preemptions += 1
                        vt = victim.prompt_len + victim.generated
                        kvc_d.free(victim.rid)
                        xfer = 2 * cost.swap_time(vt)
                        victim.swap_time += xfer
                        victim.set_state(State.PREEMPTED, tD)
                        dq.append((tD + xfer, victim))
                    if tokens > kvc_d.allocated_tokens(r.rid):
                        continue           # could not grow this round
                r.generated += 1
                kvc_d.add_used(r.rid, 1)
                if r.done:
                    running_d.remove(r)
                    r.set_state(State.COMPLETED, tD)
                    r.t_complete = tD
                    kvc_d.free(r.rid)
                    completed += 1
                    n_done += 1
            samples.append(IterSample(
                t=tD, dt=dt, forward_size=len(ctxs), prompt_tokens=0,
                n_decode=len(ctxs),
                kvc_used_frac=(kvc_p.utilization + kvc_d.utilization) / 2,
                kvc_alloc_frac=(kvc_p.allocated_frac + kvc_d.allocated_frac) / 2,
                sched_time=0.0, extra_time=0.0, n_completed=n_done))
        elif dq:
            tD = max(tD, min(rt for rt, _ in dq))
        elif i_arr < n:
            tD = max(tD, reqs[i_arr].arrival)
        elif not progressed and not pq:
            break
        if not progressed and not ready and not running_d and not pq \
                and i_arr >= n and not dq:
            break

    return SimResult(name="distserve", requests=list(reqs), samples=samples,
                     wall_time=max(tP, tD), tfs=cfg.tfs,
                     n_alloc_failures=kvc_d.n_failures + kvc_p.n_failures,
                     n_allocs=kvc_d.n_allocs + kvc_p.n_allocs)
