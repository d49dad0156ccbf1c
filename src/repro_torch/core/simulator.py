"""Discrete-event serving simulator.

``SimInstance`` models ONE engine instance as a steppable process: deliver
arrivals → form batch → advance the instance clock by scheduling +
iteration time → commit iteration effects. ``simulate`` drives a single
instance to completion (the original single-engine loop, unchanged in
behavior); ``repro_torch.cluster.sim.ClusterSim`` interleaves N instances under a
shared event clock using the same primitive.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .costmodel import CostModel
from .metrics import IterSample, SimResult
from .request import Request
from .scheduler import BaseScheduler


class SimInstance:
    """One serving instance as a discrete-event process.

    The instance owns its local clock ``t``: each committed ``step`` forms a
    batch at ``t`` and advances to the iteration's end time. Arrivals are
    pushed in via ``deliver`` (a queued request is visible to the next
    ``form_batch``); an idle instance's clock may be jumped forward by the
    caller before delivering (``advance_to``).
    """

    STEPPED = 1       # an iteration committed; clock advanced
    IDLE = 0          # empty plan: nothing schedulable at the current clock
    CUTOFF = -1       # the iteration would cross max_time; nothing committed

    def __init__(self, scheduler: BaseScheduler, cost: CostModel,
                 collect_samples: bool = True):
        self.scheduler = scheduler
        self.cost = cost
        self.collect_samples = collect_samples
        self.samples: List[IterSample] = []
        self.t = 0.0
        self.iters = 0

    # ------------------------------------------------------------------ #
    def deliver(self, req: Request, t: float) -> None:
        self.scheduler.on_arrival(req, t)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def advance_to(self, t: float) -> None:
        """Jump an idle instance's clock forward (never backward)."""
        self.t = max(self.t, t)

    # ------------------------------------------------------------------ #
    def step(self, max_time: Optional[float] = None) -> int:
        """Run one iteration at the instance clock. Returns ``STEPPED``
        when an iteration committed (clock advanced to its end time),
        ``IDLE`` when the plan was empty, ``CUTOFF`` when the iteration
        would end past ``max_time`` (nothing committed)."""
        plan = self.scheduler.form_batch(self.t)
        if plan.empty:
            return self.IDLE
        ctxs = [r.prompt_len + r.generated for r in plan.decode_reqs]
        dt = self.cost.iteration_time(plan.prompt_tokens, ctxs)
        t_end = self.t + plan.sched_time + plan.extra_time + dt
        if max_time is not None and t_end > max_time:
            return self.CUTOFF
        for req, _ in plan.prompt_items:
            req.sched_time += plan.sched_time
        n_before = len(self.scheduler.completed)
        self.scheduler.finish_iteration(t_end)
        n_done = len(self.scheduler.completed) - n_before
        if self.collect_samples:
            self.samples.append(IterSample(
                t=t_end, dt=dt, forward_size=plan.forward_size,
                prompt_tokens=plan.prompt_tokens,
                n_decode=len(plan.decode_reqs),
                kvc_used_frac=self.scheduler.kvc.utilization,
                kvc_alloc_frac=self.scheduler.kvc.allocated_frac,
                sched_time=plan.sched_time, extra_time=plan.extra_time,
                n_completed=n_done))
        self.t = t_end
        self.iters += 1
        return self.STEPPED

    # ------------------------------------------------------------------ #
    def result(self, requests: Sequence[Request]) -> SimResult:
        sched = self.scheduler
        return SimResult(
            name=sched.name, requests=list(requests), samples=self.samples,
            wall_time=self.t, tfs=sched.cfg.tfs,
            n_alloc_failures=sched.kvc.n_failures,
            n_allocs=sched.kvc.n_allocs,
            n_preempt_swap=getattr(sched, "n_preempt_swap", 0),
            n_preempt_free=getattr(sched, "n_preempt_free", 0),
            n_underprov=getattr(sched, "n_underprov", 0),
            n_reserve_rescues=getattr(sched, "n_reserve_rescues", 0))


def simulate(requests: Sequence[Request], scheduler: BaseScheduler,
             cost: CostModel, max_time: Optional[float] = None,
             max_iters: int = 2_000_000,
             collect_samples: bool = True) -> SimResult:
    """``collect_samples=False`` skips per-iteration IterSample records —
    for production-size traces where only aggregate results matter the
    sample list (and its per-iteration KVC snapshots) is pure overhead."""
    reqs = sorted(requests, key=lambda r: r.arrival)
    n = len(reqs)
    i_arr = 0
    inst = SimInstance(scheduler, cost, collect_samples)

    while inst.iters < max_iters:
        # deliver due arrivals
        while i_arr < n and reqs[i_arr].arrival <= inst.t + 1e-12:
            inst.deliver(reqs[i_arr], inst.t)
            i_arr += 1
        status = inst.step(max_time)
        if status == SimInstance.IDLE:
            if i_arr < n:
                inst.advance_to(reqs[i_arr].arrival)
                continue
            break                                    # drained
        if status == SimInstance.CUTOFF:
            break
        if i_arr >= n and not scheduler.has_work():
            break

    return inst.result(reqs)
