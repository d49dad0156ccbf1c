"""Cluster discrete-event simulator: one request stream over N instances.

Each instance is a ``repro_torch.core.simulator.SimInstance`` (the same stepping
primitive the single-engine ``simulate`` uses) with its own scheduler and
KVC; ``ClusterSim`` interleaves them under a shared event clock:

  * the next event is the earliest of (next unrouted arrival, next ready
    KV migration, earliest instance able to step); arrivals/migrations are
    routed exactly when they become the earliest event, so every routing
    decision observes instance state as of that moment;
  * a routed request is *delivered* to its instance only once the instance
    clock reaches it (an instance mid-iteration cannot see a request that
    arrives inside the iteration — same semantics as the single-engine
    loop);
  * instance **roles** model disaggregated serving à la DistServe: a
    ``prefill`` instance's finished prompts are pulled out of its GT queue
    and migrated — KV freed at the source, a ``kv_transfer_time`` delay,
    then queued-GT delivery at a ``decode`` instance chosen by the decode
    router. ``unified`` instances (the default) serve both phases;
  * an optional ``GoodputAutoscaler`` is evaluated at every arrival: +1
    adds a fresh unified instance at the current time, -1 marks the
    least-loaded unified instance *draining* (no new routes; in-flight
    work finishes; the instance retires when empty).

Conservation is tracked structurally: every submitted rid is routed at
most once (``double_routes`` counts violations) and must complete on
exactly one instance (``ClusterResult.conservation``) — the gate
``benchmarks/hotpath_micro.py --check`` enforces in CI.

Scheduler contract: role-based migration moves requests through
``scheduler.gt_queue``, which the EconoServe/MultiRes family consumes
(vLLM/ORCA-style baselines keep private running lists and only support
``unified`` roles).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.metrics import SimResult
from repro_torch.core.request import Request, State
from repro_torch.core.scheduler import BaseScheduler
from repro_torch.core.simulator import SimInstance

from .autoscale import GoodputAutoscaler
from .base import (DEAD, DetectorConfig, FailureDetector, HEALTHY,
                   InstanceBase, ROLES, execute_autoscale, validate_roles)
from .faults import FaultInjector, RecoveryConfig, backoff_delay
from .hedge import HedgeConfig, HedgeCoordinator
from .router import Router, make_router
from .transport import Transport

_INF = float("inf")
_EPS = 1e-12

__all__ = ["ClusterInstance", "ClusterResult", "ClusterSim", "ROLES"]


class ClusterInstance(InstanceBase):
    """One simulated instance plus its routing-visible stats."""

    def __init__(self, iid: int, sim: SimInstance, role: str = "unified"):
        super().__init__(iid, role)
        self.sim = sim
        self.stalled = False          # has work the scheduler cannot place
        # routed-but-undelivered requests: (deliver_t, req, as_gt, dkey),
        # kept time-sorted — routing happens in global event-time order
        # and a transport delay re-sorts on insert
        self.pending: List[Tuple[float, Request, bool, Optional[tuple]]] = []
        self._seen: set = set()       # delivery keys applied (idempotency)
        self.n_dup_deliveries = 0     # duplicates suppressed at this rank

    @property
    def scheduler(self):
        return self.sim.scheduler

    def outstanding_tokens(self) -> int:
        tot = super().outstanding_tokens()
        for _, r, _, _ in self.pending:
            tot += (r.prompt_len - r.prompt_done) + r.remaining_predicted
        return tot

    # -- event-loop interface ------------------------------------------ #
    def next_time(self) -> float:
        if self.crashed or (self.health == DEAD and not self.detected):
            return _INF               # silent carcass: only the detector
            # (or a declared kill) frees its work. A *detected* DEAD
            # instance that never crashed is a zombie (partitioned away
            # from the control plane): it keeps stepping — its output is
            # fenced at the delivery boundary, not by freezing it
        t = _INF
        if self.sim.has_work() and not self.stalled:
            t = self.sim.t
        elif self.pending:
            t = max(self.sim.t, self.pending[0][0])
        if t != _INF and self.frozen_until > t:
            t = max(t, self.frozen_until)    # frozen: wakes at the thaw
        return t

    def deliver_due(self) -> None:
        if not self.pending:
            return
        if not (self.sim.has_work() and not self.stalled):
            self.sim.advance_to(self.pending[0][0])
        while self.pending and self.pending[0][0] <= self.sim.t + _EPS:
            _, req, as_gt, dkey = self.pending.pop(0)
            if dkey is not None:
                if dkey in self._seen:
                    self.n_dup_deliveries += 1   # at-least-once duplicate
                    continue                     # suppressed: exactly-once
                self._seen.add(dkey)             # effect on the instance
            if as_gt:
                self.sim.scheduler.enqueue_gt(req)
            else:
                self.sim.deliver(req, self.sim.t)
            self.stalled = False

    def idle(self) -> bool:
        return not self.sim.has_work() and not self.pending


@dataclass
class ClusterResult:
    """Fleet-level aggregate + per-instance SimResults."""
    name: str
    requests: List[Request]
    per_instance: List[SimResult]
    wall_time: float
    n_routed: int = 0
    n_migrations: int = 0
    double_routes: int = 0
    route_of: Dict[int, int] = field(default_factory=dict)
    completed_by: Dict[int, List[int]] = field(default_factory=dict)
    scale_events: List[Tuple[float, int]] = field(default_factory=list)
    aborted: List[int] = field(default_factory=list)   # terminal, not done
    n_recovered: int = 0
    fault_log: List[Tuple[float, str, int]] = field(default_factory=list)
    # detected-failure / shed-retry accounting (zero in declared mode)
    n_shed_reroutes: int = 0     # rung-4 sheds handed to the retry tier
    n_shed_rescued: int = 0      # of those, delivered to a feasible peer
    n_shed_terminal: int = 0     # of those, shed for good (no peer fits)
    n_dup_deliveries: int = 0    # duplicates suppressed by idempotency
    n_false_suspects: int = 0    # suspects reinstated by a fresh beat
    # hedged execution / partition fencing (zero with hedging off and no
    # partition faults)
    n_fenced_completions: int = 0   # zombie completions counted, dropped
    n_hedges_fired: int = 0
    n_hedges_won: int = 0           # clone beat its primary
    n_hedges_cancelled: int = 0     # losers cancelled (either side)
    detector_transitions: List[Tuple[float, int, str, str]] = \
        field(default_factory=list)
    transport_stats: Dict[str, int] = field(default_factory=dict)

    @property
    def n_instances(self) -> int:
        return len(self.per_instance)

    @property
    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.t_complete is not None]

    @property
    def goodput(self) -> float:
        """SLO-met completions per second across the fleet (fig 12)."""
        return sum(r.met_slo for r in self.completed) \
            / max(1e-9, self.wall_time)

    @property
    def ssr(self) -> float:
        c = self.completed
        return sum(r.met_slo for r in c) / max(1, len(c))

    @property
    def throughput_reqs(self) -> float:
        return len(self.completed) / max(1e-9, self.wall_time)

    def conservation(self) -> Dict[str, int]:
        """Structural invariant: every routed rid reaches exactly one
        terminal state — completed on exactly one instance, or aborted
        (retry budget / deadline / no-live-instance) — with zero
        double-routes."""
        counts: Dict[int, int] = {}
        for rids in self.completed_by.values():
            for rid in rids:
                counts[rid] = counts.get(rid, 0) + 1
        aborted = set(self.aborted)
        dups = sum(1 for c in counts.values() if c > 1)
        both = sum(1 for rid in aborted if counts.get(rid, 0) > 0)
        missing = sum(1 for rid in self.route_of
                      if counts.get(rid, 0) == 0 and rid not in aborted)
        return {"submitted": len(self.requests),
                "routed": self.n_routed,
                "completed": len(counts),
                "aborted": len(aborted),
                "duplicate_completions": dups,
                "uncompleted_routed": missing,
                "double_routes": self.double_routes,
                "fenced_completions": self.n_fenced_completions,
                "hedges_fired": self.n_hedges_fired,
                "hedges_won": self.n_hedges_won,
                "hedges_cancelled": self.n_hedges_cancelled,
                "ok": int(dups == 0 and both == 0
                          and self.double_routes == 0
                          and missing == 0
                          and len(counts) + len(aborted)
                          == len(self.requests))}


class ClusterSim:
    def __init__(self, scheduler_factory: Callable[[int], BaseScheduler],
                 cost: CostModel, n_instances: int = 2,
                 router: str = "least-kvc",
                 roles: Optional[Sequence[str]] = None,
                 seed: int = 0,
                 autoscaler: Optional[GoodputAutoscaler] = None,
                 faults: Optional[FaultInjector] = None,
                 recovery: Optional[RecoveryConfig] = None,
                 detector: Optional[DetectorConfig] = None,
                 hedge: Optional[HedgeConfig] = None,
                 collect_samples: bool = False,
                 name: Optional[str] = None):
        self.factory = scheduler_factory
        self.cost = cost
        self.collect_samples = collect_samples
        self.faults = faults
        self.recovery = recovery or RecoveryConfig()
        roles = validate_roles(roles, n_instances)
        self.instances: List[ClusterInstance] = [
            ClusterInstance(i, SimInstance(scheduler_factory(i), cost,
                                           collect_samples), roles[i])
            for i in range(n_instances)]
        # detected failure: the sim keeps its own delivery structures (the
        # pending lists + migration heap) and asks the transport only to
        # *judge* each send, so one chaos schedule reproduces on either
        # backend; heartbeats/leases drive observed health exactly as on
        # the real-engine fleet
        self.detector_cfg = detector
        self.transport = Transport(seed=seed + 7) \
            if detector is not None else None
        self.detector = FailureDetector(detector, self.transport) \
            if detector is not None else None
        if self.detector is not None:
            for inst in self.instances:
                inst.detected = True
            if self.faults is not None:
                self.faults.detected = True
                self.faults.transport = self.transport
        self.router: Router = make_router(router, seed) \
            if isinstance(router, str) else router
        # migrations get their own router instance (same policy) so the
        # decode-side cycle/tie stream is independent of the arrival side
        rname = self.router.name if not isinstance(router, str) else router
        self.decode_router: Router = make_router(rname, seed + 1)
        self.autoscaler = autoscaler
        self.name = name or f"cluster-{rname}-x{n_instances}"
        # conservation / accounting
        self.route_of: Dict[int, int] = {}
        self.double_routes = 0
        self.n_migrations = 0
        self.scale_events: List[Tuple[float, int]] = []
        self._next_id = n_instances
        self._mig_seq = 0
        # fault-tolerance accounting
        self._retries: Dict[int, int] = {}       # rid -> recovery attempts
        self._dead_handled: set = set()
        self.aborted_rids: List[int] = []
        self.n_recovered = 0
        # at-least-once delivery epochs (rid -> epoch) + shed-retry tier
        self._epoch: Dict[int, int] = {}
        self._migrations: List = []              # bound to run()'s heap
        self._shed_rids: set = set()             # rids in the retry tier
        self.n_shed_reroutes = 0
        self.n_shed_rescued = 0
        self.n_shed_terminal = 0
        # hedged execution + partition fencing. Fencing (zombies, clone
        # recovery, winner snapshots) is independent of hedging: partition
        # chaos with hedging off still needs it for conservation
        self.hedge = HedgeCoordinator(hedge) if hedge is not None else None
        if self.hedge is not None:
            assert detector is not None, \
                "hedging requires the failure detector (suspect signal)"
        self._hedge_seq = 0                      # global epoch stream
        self._hedge_live: Dict[int, Request] = {}    # watched originals
        # rid -> {orig, clone, piid, ciid?, p_gone?}: one in-flight race
        self._races: Dict[int, dict] = {}
        self._host_of: Dict[int, int] = {}       # rid -> last chosen host
        self._fenced: set = set()                # (iid, rid): zombie side
        self._dead_objs: set = set()             # id(Request): race losers
        # rid -> (orig, winner-src): terminal fields re-applied at run()
        # end — a fenced zombie may stomp the client record mid-run
        self._swap_result: Dict[int, Tuple[Request, Request]] = {}
        self._cancel_at: List = []               # (heal_t, seq, iid, rid)
        self.n_fenced_completions = 0

    def _dkey(self, rid: int) -> tuple:
        """Fresh delivery key for one intentional (re)delivery of rid."""
        ep = self._epoch.get(rid, 0) + 1
        self._epoch[rid] = ep
        return (rid, ep)

    # ------------------------------------------------------------------ #
    def _route(self, req: Request, t: float, as_gt: bool,
               rerouted: bool = False) -> None:
        if id(req) in self._dead_objs:
            return          # fenced race loser: never resurrected
        cands = [i for i in self.instances
                 if (i.accepts_decodes() if as_gt else i.accepts_prompts())]
        if not cands:
            # every eligible instance is draining or degraded: fall back
            # to any live instance of the right role (a route beats
            # dropping the request), then to any live instance at all
            want = ("unified", "decode") if as_gt else ("unified", "prefill")
            cands = [i for i in self.instances
                     if i.alive and i.role in want] \
                or [i for i in self.instances if i.alive]
        race = self._races.get(req.rid)
        if race is not None and race["clone"] is req:
            # a hedge clone must never land on its own primary (same-rid
            # collision inside one scheduler); with no other peer left
            # the race dissolves and the primary runs alone
            cands = [i for i in cands if i.id != race["piid"]]
            if not cands:
                self._abandon_race(req.rid, t)
                return
        if not cands:
            # whole fleet is dead: the request cannot be served, ever —
            # record a terminal abort instead of losing it silently
            req.set_state(State.ABORTED, t)
            self.aborted_rids.append(req.rid)
            return
        demand = req.prompt_len + max(req.padded_rl, req.predicted_rl, 1)
        if rerouted and req.rid in self._shed_rids:
            # shed-retry tier: only a peer whose *total* KVC can ever fund
            # the frozen exact-alloc demand may receive a rung-4 shed
            fits = [i for i in cands if i.scheduler.fits_ever(demand)]
            if not fits:
                if any(i.alive and i.scheduler.fits_ever(demand)
                       for i in self.instances):
                    # a feasible peer exists but is not routable right
                    # now (draining/degraded): burn a retry and wait
                    self._recover(req, t, self._migrations)
                else:
                    self.n_shed_terminal += 1
                    req.set_state(State.ABORTED, t)
                    self.aborted_rids.append(req.rid)
                return
            cands = fits
            self.n_shed_rescued += 1
        router = self.decode_router if as_gt else self.router
        inst = router.choose(cands, demand)
        if not as_gt:
            if req.rid in self.route_of and not rerouted:
                self.double_routes += 1
            self.route_of[req.rid] = inst.id
            if not rerouted and self.hedge is not None \
                    and self.hedge.cfg.enabled:
                self.hedge.track(req.rid, t)
                self._hedge_live[req.rid] = req
        if rerouted and self.hedge is not None and self.hedge.cfg.enabled:
            # re-delivery re-arms the stall clocks: the new host deserves
            # a full threshold window before being called a straggler
            self.hedge.reset_progress(req.rid, req.generated, t)
        self._deliver(inst, req, t, as_gt)

    def _deliver(self, inst: ClusterInstance, req: Request, t: float,
                 as_gt: bool) -> None:
        """Hand one routed request to its instance — through the lossy
        transport's verdict when detection is on (drop => retransmit via
        the shared event heap, dup => two pending copies sharing one
        delivery key, delay => deferred and possibly overtaken)."""
        race = self._races.get(req.rid)
        if race is not None and race["clone"] is req:
            race["ciid"] = inst.id       # clone-side fence key tracks
        else:                            # the host actually delivered to
            self._host_of[req.rid] = inst.id
        if self.transport is None:
            inst.pending.append((t, req, as_gt, None))
            inst.stalled = False
            return
        dkey = self._dkey(req.rid)
        v = self.transport.judge(inst.id, t)
        if v.heal > 0.0:
            # partitioned link: the sender's retry timer holds the send
            # and re-routes once the partition heals (fresh decision,
            # fresh epoch) — data is never silently lost to a partition
            self._mig_seq += 1
            heapq.heappush(self._migrations,
                           (max(t + self.transport.retransmit_after,
                                v.heal),
                            self._mig_seq, req, as_gt))
            return
        deliver_t = t + v.delay
        if v.drop:
            # at-least-once: the sender's retry timer re-sends (a fresh
            # routing decision and a fresh epoch — the original is gone)
            self.transport.n_retransmits += 1
            self._mig_seq += 1
            heapq.heappush(self._migrations,
                           (deliver_t + self.transport.retransmit_after,
                            self._mig_seq, req, as_gt))
            return
        self._push_pending(inst, deliver_t, req, as_gt, dkey)
        if v.dup:
            self._push_pending(inst, deliver_t, req, as_gt, dkey)

    @staticmethod
    def _push_pending(inst: ClusterInstance, deliver_t: float,
                      req: Request, as_gt: bool, dkey) -> None:
        inst.pending.append((deliver_t, req, as_gt, dkey))
        if len(inst.pending) > 1 and inst.pending[-2][0] > deliver_t:
            # a delayed message was overtaken: restore delivery order
            # (stable sort keeps FIFO among equal times)
            inst.pending.sort(key=lambda p: p[0])
        inst.stalled = False

    def _collect_migrations(self, inst: ClusterInstance,
                            heap: List) -> None:
        """Pull finished prompts off a prefill instance: free their KVC,
        pay the KV transfer, and schedule queued-GT delivery at a decode
        instance (chosen when the transfer lands)."""
        sched = inst.sim.scheduler
        for r in list(sched.gt_queue):
            sched.gt_queue.remove(r)
            sched.kvc.free(r.rid)
            tokens = r.prompt_len + r.generated
            r.occupied_kvc = tokens          # held in transfer/host memory
            xfer = self.cost.kv_transfer_time(tokens)
            r.swap_time += xfer
            self._mig_seq += 1
            heapq.heappush(heap, (inst.sim.t + xfer, self._mig_seq, r, True))
            self.n_migrations += 1

    # -- fault handling / crash recovery -------------------------------- #
    def _reclaim_dead(self, t: float, heap: List) -> None:
        """Sweep newly-dead instances: pull every non-terminal request off
        the carcass (undelivered pendings, queues, running groups — the
        scheduler's ``cancel`` releases KVC and cascades pipelined
        orphans) and queue each for recovery elsewhere."""
        for inst in self.instances:
            if inst.alive or inst.id in self._dead_handled:
                continue
            self._dead_handled.add(inst.id)
            if inst.detected and not inst.crashed:
                # declared dead but still running: a partitioned zombie —
                # fence it instead of cancelling through the partition
                self._reclaim_zombie(inst, t, heap)
                continue
            victims, vseen = [], set()
            for _, r, _, _ in inst.pending:
                if r.rid not in vseen:      # dup'd copies: recover once
                    vseen.add(r.rid)
                    victims.append(r)
            inst.pending.clear()
            inst.stalled = False
            sched = inst.sim.scheduler
            while True:
                nxt = next(iter(sched.pt_queue), None) \
                    or next(iter(sched.gt_queue), None)
                if nxt is None:
                    nxt = next((m for g in sched.running_groups
                                for m in g.members), None)
                if nxt is None:
                    break
                c = sched.cancel(nxt.rid, t)
                if c is None:          # defensive: avoid an infinite sweep
                    break
                victims.append(c)
            for r in victims:
                race = self._races.get(r.rid)
                if race is not None and race["clone"] is r:
                    # the clone died with its host: the race dissolves
                    self._abandon_race(r.rid, t)
                    continue
                if race is not None and race["orig"] is r:
                    # the primary died mid-race: the clone IS the
                    # recovery — resolution will crown it
                    race["p_gone"] = True
                    continue
                if id(r) in self._dead_objs:
                    continue
                self._recover(r, t, heap)
            if self.autoscaler is not None:
                self.autoscaler.invalidate()

    def _reclaim_zombie(self, inst: "ClusterInstance", t: float,
                        heap: List) -> None:
        """A *detected*-DEAD instance that never crashed is a partitioned
        zombie: it keeps crunching, but nothing it produces from here on
        is client-visible. Undelivered pendings are recovered normally
        (they never reached the device). Requests already on the zombie
        are *fenced*: a same-rid clone re-enters service elsewhere (the
        original object stays with the zombie, so a late completion can
        never mutate what the client finally reads past the winner
        snapshot), the zombie's scheduler state is reclaimed by a cancel
        deferred to the partition heal — the first instant the control
        plane can reach it again — and any completion it produces
        meanwhile is counted, never delivered."""
        victims, vseen = [], set()
        for _, r, _, _ in inst.pending:
            if r.rid not in vseen and id(r) not in self._dead_objs:
                vseen.add(r.rid)
                victims.append(r)
        inst.pending.clear()
        inst.stalled = False
        for r in victims:
            race = self._races.get(r.rid)
            if race is not None and race["clone"] is r:
                self._abandon_race(r.rid, t)
                continue
            self._recover(r, t, heap)
        heal = t
        if self.transport is not None:
            heal = max(t, self.transport.partition_heal(inst.id, t))
        sched = inst.sim.scheduler
        held = list(sched.pt_queue) + list(sched.gt_queue) \
            + [m for g in sched.running_groups for m in g.members]
        hseen = set()
        for r in held:
            if r.rid in hseen or r.t_complete is not None:
                continue
            hseen.add(r.rid)
            self._fenced.add((inst.id, r.rid))
            self._mig_seq += 1
            heapq.heappush(self._cancel_at,
                           (heal, self._mig_seq, inst.id, r.rid))
            if self._races.get(r.rid) is not None:
                continue     # racing: the hedge clone is the recovery
            if id(r) in self._dead_objs:
                continue
            clone = self._clone_request(r)
            self._swap_result[r.rid] = (r, clone)
            self._hedge_live.pop(r.rid, None)
            if self.hedge is not None:
                self.hedge.watchdog.forget(r.rid)
            self._recover(clone, t, heap)
        if self.autoscaler is not None and (victims or hseen):
            self.autoscaler.invalidate()

    def _recover(self, req: Request, t: float, heap: List) -> None:
        """Requeue a reclaimed request with bounded retries + exponential
        backoff. Progressed requests re-enter as queued GTs holding their
        context 'in host memory' (the swap-recompute path re-onboards
        them); unstarted ones are re-routed as fresh PTs."""
        if id(req) in self._dead_objs:
            return               # fenced race loser: never resurrected
        att = self._retries.get(req.rid, 0)
        if att >= self.recovery.max_retries:
            if req.rid in self._shed_rids:
                self.n_shed_terminal += 1    # retry tier exhausted: the
            req.set_state(State.ABORTED, t)  # shed becomes terminal
            self.aborted_rids.append(req.rid)
            return
        self._retries[req.rid] = att + 1
        delay = backoff_delay(self.recovery, req.rid, att)
        as_gt = req.generated > 0
        if as_gt:
            req.prompt_done = req.prompt_len
            req.occupied_kvc = req.prompt_len + req.generated
        else:
            req.prompt_done = 0
            req.occupied_kvc = 0
        req.n_preemptions += 1
        req.set_state(State.QUEUED_GT if as_gt else State.QUEUED_PT, t)
        self._mig_seq += 1
        heapq.heappush(heap, (t + delay, self._mig_seq, req, as_gt))
        self.n_recovered += 1

    # -- hedged execution ----------------------------------------------- #
    @staticmethod
    def _clone_request(src: Request) -> Request:
        """Private same-rid copy for re-delivery while the original is
        stranded behind a fence (or racing as a hedge): the rid is the
        fleet-level identity, but a distinct object means the fenced
        side can never mutate what the client finally reads."""
        c = Request(rid=src.rid, prompt_len=src.prompt_len,
                    true_rl=src.true_rl, arrival=src.arrival,
                    slo_deadline=src.slo_deadline)
        c.predicted_rl = src.predicted_rl
        c.padded_rl = src.padded_rl
        c.generated = src.generated
        c.t_first_token = src.t_first_token
        c.n_preemptions = src.n_preemptions
        return c

    @staticmethod
    def _apply_snapshot(orig: Request, src: Request) -> None:
        """Re-apply the winner's client-visible terminal fields onto the
        original (client-held) record — a fenced zombie may have stomped
        them with completions the client never saw."""
        if src is orig:
            return
        if src.t_complete is None and src.state != State.ABORTED:
            return
        orig.state = src.state
        orig.t_complete = src.t_complete
        orig.generated = src.generated
        if src.t_first_token is not None:
            orig.t_first_token = src.t_first_token \
                if orig.t_first_token is None \
                else min(orig.t_first_token, src.t_first_token)

    def _drop_pending(self, obj: Request) -> None:
        for inst in self.instances:
            if any(p[1] is obj for p in inst.pending):
                inst.pending = [p for p in inst.pending
                                if p[1] is not obj]

    def _cancel_loser(self, rid: int, loser: Request, t: float) -> None:
        """Fence + cancel the losing copy of a resolved race everywhere
        it could still run: live schedulers detach it now (releasing
        KVC/slots), zombies reconcile through the cancel already
        deferred to their partition heal, and the object is marked dead
        so the recovery/retransmit paths can never resurrect it. The
        winner is terminal, so by construction the scan can only ever
        detach the loser."""
        self._dead_objs.add(id(loser))
        self._drop_pending(loser)
        for inst in self.instances:
            if not inst.alive or inst.crashed:
                continue
            sched = inst.sim.scheduler
            held = any(q.rid == rid for q in list(sched.pt_queue)) \
                or any(q.rid == rid for q in list(sched.gt_queue)) \
                or any(m.rid == rid for g in sched.running_groups
                       for m in g.members)
            if held:
                sched.cancel(rid, t)

    def _abandon_race(self, rid: int, t: float) -> None:
        """The clone died without a client-visible completion (its host
        crashed, was fenced, or no peer could host it): the race
        dissolves with no winner. If the primary is still live it races
        on alone; if both copies are gone, recover from the
        furthest-progressed snapshot so the request still reaches
        exactly one terminal state."""
        ent = self._races.pop(rid)
        orig, clone = ent["orig"], ent["clone"]
        self.hedge.abandon(rid)
        self._dead_objs.add(id(clone))
        self._drop_pending(clone)
        p_live = not ent.get("p_gone") \
            and (ent["piid"], rid) not in self._fenced
        if p_live:
            return
        src = clone if clone.generated >= orig.generated else orig
        c2 = self._clone_request(src)
        self._swap_result[rid] = (orig, c2)
        self._hedge_live.pop(rid, None)
        self.hedge.watchdog.forget(rid)
        self._recover(c2, t, self._migrations)

    def _launch_hedge(self, r: Request, piid: Optional[int], reason: str,
                      t: float) -> None:
        """Race a stalled/suspect-hosted request on the best live peer:
        a same-rid clone seeded with the client-visible progress enters
        under a fresh delivery epoch; first terminal transition wins."""
        as_gt = r.generated > 0
        cands = [i for i in self.instances
                 if (i.accepts_decodes() if as_gt else i.accepts_prompts())
                 and i.id != piid]
        if not cands:
            return               # no live peer to race against
        clone = self._clone_request(r)
        if as_gt:
            clone.prompt_done = clone.prompt_len
            clone.occupied_kvc = clone.prompt_len + clone.generated
            clone.n_preemptions += 1
            clone.set_state(State.QUEUED_GT, t)
        demand = clone.prompt_len + max(clone.padded_rl,
                                        clone.predicted_rl, 1)
        router = self.decode_router if as_gt else self.router
        inst = router.choose(cands, demand)
        self._hedge_seq += 1
        self.hedge.launch(r.rid, (self._hedge_seq,), inst.id, reason)
        self._races[r.rid] = {"orig": r, "clone": clone, "piid": piid,
                              "ciid": inst.id}
        self._deliver(inst, clone, t, as_gt)

    def _resolve_races(self, t: float) -> None:
        """First terminal transition wins; the loser is fenced+cancelled.
        A terminal transition behind a fence is not client-visible and
        can never win."""
        for rid, ent in list(self._races.items()):
            orig, clone, piid = ent["orig"], ent["clone"], ent["piid"]
            ciid = ent.get("ciid")
            p_live = not ent.get("p_gone") \
                and (piid, rid) not in self._fenced
            c_live = ciid is None or (ciid, rid) not in self._fenced
            if orig.t_complete is not None and p_live:
                self.hedge.resolve(rid, "primary", piid)
                self._cancel_loser(rid, clone, t)
                self._hedge_live.pop(rid, None)
                del self._races[rid]
                continue
            if clone.t_complete is not None and c_live:
                self.hedge.resolve(rid, "clone", piid)
                if p_live:
                    self._cancel_loser(rid, orig, t)
                else:
                    self._dead_objs.add(id(orig))
                self._swap_result[rid] = (orig, clone)
                self._apply_snapshot(orig, clone)
                self._hedge_live.pop(rid, None)
                del self._races[rid]
                continue
            clone_dead = clone.state == State.ABORTED \
                or (clone.t_complete is not None and not c_live)
            if clone_dead:
                self._abandon_race(rid, t)

    def _hedge_tick(self, t: float, heap: List) -> None:
        """Per-event hedging pass: resolve finished races, feed the
        progress watchdog with client-visible progress, and launch a
        clone for any request that stalled or whose host went suspect.
        Runs after every step/detector event so a completion is always
        observed before any other instance can produce a second one."""
        hedge = self.hedge
        if hedge is None or not hedge.cfg.enabled:
            return
        self._resolve_races(t)
        for rid, r in list(self._hedge_live.items()):
            if rid in self._races:
                continue                  # racing: resolution handles it
            if r.t_complete is not None or r.state == State.ABORTED:
                hedge.mark_terminal(rid)
                del self._hedge_live[rid]
                continue
            hedge.observe_progress(rid, r.generated, t)
            piid = self._host_of.get(rid)
            inst = next((i for i in self.instances if i.id == piid), None)
            suspect = inst is not None and inst.health != HEALTHY
            reason = hedge.want_hedge(rid, t, host_suspect=suspect)
            if reason is None:
                continue
            if any(m[2] is r for m in heap):
                continue                  # mid-recovery: re-route first
            self._launch_hedge(r, piid, reason, t)

    def _apply_due_cancels(self, t: float) -> None:
        """Heal-deferred fencing cancels: the first instant the control
        plane can reach a zombie again, its fenced scheduler state is
        reclaimed (KVC freed, groups cascaded). A rid the zombie already
        finished cancels to nothing — the completion stays fenced."""
        while self._cancel_at and self._cancel_at[0][0] <= t + _EPS:
            _, _, iid, rid = heapq.heappop(self._cancel_at)
            inst = next((i for i in self.instances if i.id == iid), None)
            if inst is None or inst.crashed:
                continue
            inst.sim.scheduler.cancel(rid, t)

    # ------------------------------------------------------------------ #
    def _spawn(self, t: float) -> None:
        iid = self._next_id
        self._next_id += 1
        inst = ClusterInstance(
            iid, SimInstance(self.factory(iid), self.cost,
                             self.collect_samples), "unified")
        inst.sim.advance_to(t)
        if self.detector is not None:
            inst.detected = True
        self.instances.append(inst)

    def _autoscale(self, t: float) -> None:
        if self.autoscaler is not None:
            execute_autoscale(self.autoscaler, t, self.instances,
                              self._spawn, self.scale_events)

    def publish_metrics(self, registry) -> None:
        """Publish the cluster — every instance's scheduler+KVC
        (instance-labelled), routers, autoscaler, detector, transport,
        and the conservation counters — into a ``repro_torch.obs`` registry.
        Same families the real ``EngineFleet`` publishes, so dashboards
        and the trace replayer read one schema for both backends."""
        health_g = registry.gauge(
            "fleet_instance_health", "observed health: healthy=0 "
            "suspect=1 dead=2", ("instance",))
        from .base import HEALTH_STATES
        for inst in self.instances:
            inst.sim.scheduler.publish_metrics(
                registry, instance=str(inst.id))
            health_g.labels(instance=inst.id).set(
                HEALTH_STATES.index(inst.health))
            registry.gauge(
                "cluster_pending_deliveries",
                "routed-but-undelivered requests", ("instance",)) \
                .labels(instance=inst.id).set(len(inst.pending))
        self.router.publish_metrics(registry, side="arrival")
        self.decode_router.publish_metrics(registry, side="decode")
        if self.autoscaler is not None:
            self.autoscaler.publish_metrics(registry)

        def c(name, help, value):
            registry.counter(name, help).unlabeled.inc_to(value)

        c("cluster_routed_total", "requests routed", len(self.route_of))
        c("cluster_migrations_total", "prefill->decode KV migrations",
          self.n_migrations)
        c("cluster_double_routes_total", "conservation violations "
          "(must stay 0)", self.double_routes)
        c("cluster_recovered_total", "requests requeued off dead "
          "instances", self.n_recovered)
        c("cluster_aborted_total", "terminal aborts",
          len(self.aborted_rids))
        c("cluster_shed_reroutes_total", "rung-4 sheds handed to the "
          "retry tier", self.n_shed_reroutes)
        c("cluster_shed_rescued_total", "retried sheds delivered to a "
          "feasible peer", self.n_shed_rescued)
        c("cluster_shed_terminal_total", "sheds with no feasible peer",
          self.n_shed_terminal)
        c("cluster_dup_deliveries_total", "duplicates suppressed by "
          "idempotency", sum(i.n_dup_deliveries for i in self.instances))
        c("cluster_fenced_completions_total", "fenced-host completions "
          "counted, never delivered", self.n_fenced_completions)
        if self.transport is not None:
            tfam = registry.counter("transport_messages_total",
                                    "lossy-transport events by kind",
                                    ("kind",))
            tfam.labels(kind="dropped").inc_to(self.transport.n_dropped)
            tfam.labels(kind="duplicated").inc_to(
                self.transport.n_duplicated)
            tfam.labels(kind="delayed").inc_to(self.transport.n_delayed)
            tfam.labels(kind="retransmits").inc_to(
                self.transport.n_retransmits)
            tfam.labels(kind="partition_lost").inc_to(
                self.transport.n_partition_lost)
            tfam.labels(kind="partition_held").inc_to(
                self.transport.n_partition_held)
        if self.detector is not None:
            self.detector.publish_metrics(registry, self.instances)
        if self.hedge is not None:
            self.hedge.publish_metrics(registry)

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence[Request],
            max_iters: int = 2_000_000,
            sample_every: Optional[float] = None,
            on_sample: Optional[Callable[[float, "ClusterSim"], None]]
            = None) -> ClusterResult:
        reqs = sorted(requests, key=lambda r: r.arrival)
        n = len(reqs)
        i_arr = 0
        migrations: List[Tuple[float, int, Request, bool]] = []
        self._migrations = migrations    # _deliver/_route push retransmits
        total_iters = 0
        # time-series hook: fire on_sample every sample_every units of
        # event time (state as of the last event before each boundary)
        next_sample = sample_every if sample_every else _INF

        while total_iters < max_iters:
            t_arr = reqs[i_arr].arrival if i_arr < n else _INF
            t_mig = migrations[0][0] if migrations else _INF
            t_inst = _INF
            nxt: Optional[ClusterInstance] = None
            for inst in self.instances:
                ti = inst.next_time()
                if ti < t_inst:
                    t_inst, nxt = ti, inst
            t_evt = min(t_arr, t_mig, t_inst)
            t_det = _INF
            if self.detector is not None:
                # detection deadlines join the event horizon only while
                # work remains — a silent carcass holding requests must
                # be declared even when nothing else advances the clock
                work_left = (i_arr < n or bool(migrations)
                             or any(not i.idle() for i in self.instances))
                if work_left:
                    t_det = self.detector.next_deadline(self.instances)
            t_now = min(t_evt, t_det)
            if t_now == _INF:
                break
            if on_sample is not None:
                while t_now >= next_sample - _EPS:
                    on_sample(next_sample, self)
                    next_sample += sample_every
            if self._cancel_at:
                self._apply_due_cancels(t_now)
            if self.faults is not None:
                for inst in self.instances:
                    inst.update_health(t_now)
                if self.faults.poll(t_now, self.instances):
                    # faults change health/eligibility: reclaim any dead
                    # instance's work and re-evaluate the event horizon
                    self._reclaim_dead(t_now, migrations)
                    continue
            if self.detector is not None:
                # beat before observing: a live instance that reached
                # this wake is, by construction, still heartbeating
                for inst in self.instances:
                    inst.maybe_beat(self.transport, t_now,
                                    self.detector.cfg.beat_every)
                newly_dead = self.detector.observe(t_now, self.instances)
                if newly_dead:
                    self._reclaim_dead(t_now, migrations)
                self._hedge_tick(t_now, migrations)
                if newly_dead:
                    continue
                if t_det < t_evt:
                    continue             # pure detection wake: re-horizon
            if t_arr <= t_mig and t_arr <= t_inst:
                req = reqs[i_arr]
                i_arr += 1
                self._autoscale(t_arr)
                self._route(req, t_arr, as_gt=False)
                continue
            if t_mig <= t_inst:
                ready, _, req, as_gt = heapq.heappop(migrations)
                self._route(req, ready, as_gt=as_gt, rerouted=True)
                continue
            assert nxt is not None
            if nxt.frozen_until > nxt.sim.t:
                # thaw: the freeze consumed this wall-clock interval
                nxt.sim.advance_to(nxt.frozen_until)
            nxt.deliver_due()
            t_before = nxt.sim.t
            status = nxt.sim.step()
            sched = nxt.sim.scheduler
            if sched.infeasible_shed:
                # rung 4: a squeeze made these permanently inadmissible
                # on *this* instance. With the shed-retry tier on, a peer
                # whose total KVC can still fund the demand gets a
                # router-level re-route (bounded retries + backoff);
                # terminal shed only when no live peer can ever fit
                for r in sched.infeasible_shed:
                    demand = r.prompt_len + max(r.padded_rl,
                                                r.predicted_rl, 1)
                    if (self.recovery.shed_retry
                            and any(i.alive
                                    and i.scheduler.fits_ever(demand)
                                    for i in self.instances)):
                        self._shed_rids.add(r.rid)
                        self.n_shed_reroutes += 1
                        self._recover(r, nxt.sim.t, migrations)
                    else:
                        if self.recovery.shed_retry:
                            self.n_shed_terminal += 1
                        r.set_state(State.ABORTED, nxt.sim.t)
                        self.aborted_rids.append(r.rid)
                sched.infeasible_shed.clear()
            if status == SimInstance.STEPPED:
                total_iters += 1
                nxt.stalled = False
                if nxt.slow_factor > 1 and t_before < nxt.slow_until:
                    # straggler: dilate the iteration it just committed
                    nxt.sim.t += (nxt.slow_factor - 1) \
                        * (nxt.sim.t - t_before)
                if nxt.role == "prefill":
                    self._collect_migrations(nxt, migrations)
                if self.autoscaler is not None:
                    nxt.harvest_completions(self.autoscaler)
                self._hedge_tick(t_now, migrations)
            else:
                # empty plan while work remains: nothing placeable until a
                # new delivery arrives (mirrors the single-engine loop's
                # jump-to-next-arrival; here the next event wakes it)
                nxt.stalled = True

        # partition fences: a fenced host's post-fence completions are
        # counted, never credited — the clone that re-entered service
        # elsewhere is the one completion the client sees
        completed_by: Dict[int, List[int]] = {}
        for inst in self.instances:
            kept = []
            for r in inst.sim.scheduler.completed:
                if (inst.id, r.rid) in self._fenced:
                    self.n_fenced_completions += 1
                    if self.hedge is not None:
                        self.hedge.n_fenced += 1
                    continue
                kept.append(r.rid)
            completed_by[inst.id] = kept
        # re-apply winner snapshots: the client record must show what the
        # winning copy produced, whatever a fenced zombie wrote meanwhile
        for orig, src in self._swap_result.values():
            self._apply_snapshot(orig, src)
        wall = max((inst.sim.t for inst in self.instances), default=0.0)
        return ClusterResult(
            name=self.name, requests=list(reqs),
            per_instance=[inst.sim.result([]) for inst in self.instances],
            wall_time=wall, n_routed=len(self.route_of),
            n_migrations=self.n_migrations,
            double_routes=self.double_routes,
            route_of=dict(self.route_of), completed_by=completed_by,
            scale_events=list(self.scale_events),
            aborted=list(self.aborted_rids),
            n_recovered=self.n_recovered,
            fault_log=list(self.faults.log) if self.faults else [],
            n_shed_reroutes=self.n_shed_reroutes,
            n_shed_rescued=self.n_shed_rescued,
            n_shed_terminal=self.n_shed_terminal,
            n_dup_deliveries=sum(i.n_dup_deliveries
                                 for i in self.instances),
            n_false_suspects=(self.detector.n_reinstated
                              if self.detector else 0),
            detector_transitions=(list(self.detector.transitions)
                                  if self.detector else []),
            n_fenced_completions=self.n_fenced_completions,
            n_hedges_fired=(self.hedge.n_fired if self.hedge else 0),
            n_hedges_won=(self.hedge.n_won if self.hedge else 0),
            n_hedges_cancelled=(self.hedge.n_cancelled
                                if self.hedge else 0),
            transport_stats=({"dropped": self.transport.n_dropped,
                              "duplicated": self.transport.n_duplicated,
                              "delayed": self.transport.n_delayed,
                              "retransmits": self.transport.n_retransmits,
                              "partition_lost":
                                  self.transport.n_partition_lost,
                              "partition_held":
                                  self.transport.n_partition_held}
                             if self.transport else {}))
