"""Real-engine fleet: N in-process ``ServingEngine`` instances behind one
event loop, one router, and (optionally) disaggregated prefill/decode
roles with live KV migration.

The fleet owns the request stream: ``submit`` routes each ``GenRequest``
to exactly one engine (conservation-guarded — a request object is never
routed twice), ``step`` advances every engine that has work on a shared
iteration clock, then sweeps prefill-role engines for finished prompts and
migrates them: ``engine.export_kv`` extracts the request's cache pages and
carried slot state, ``engine.inject_kv`` seeds them into a decode engine
chosen by the decode-side router. Engines that cannot produce a portable
KV image (recurrent stacks, ring caches) — or a receiver without a free
slot / KVC room — fall back transparently to the engine's existing
swap-recompute path; either way the greedy token stream is identical to
serving the request on a single engine (``tests/test_cluster.py``).

Model parameters are built once, on the fleet's device, and shared by
every engine (caches, slots and schedulers stay per-engine), so an
N-instance fleet costs N caches, not N models. An optional
``GoodputAutoscaler`` is polled once per loop tick: +1 spawns a fresh
unified engine from the shared parameters, -1 marks one draining (no new
routes; it retires via ``has_work``).

Fault tolerance (``faults``/``recovery`` kwargs):

  * an optional ``FaultInjector`` is polled every tick; it crashes,
    freezes, or slows instances (``InstanceBase`` health lifecycle) and
    corrupts KV payloads in flight (caught by the checksum at inject);
  * **crash recovery** — when an instance dies, every in-flight request
    on it is reclaimed and redelivered with bounded retries and
    exponential backoff (optionally jittered — ``RecoveryConfig.jitter``
    — to spread the retry herd, deterministically under a fixed seed).
    A host-offloaded KV image that survived the crash (the device state
    is gone, the host pool is not) is salvaged and re-seeded into the
    receiving engine; otherwise a request with generated tokens goes
    through the swap-recompute path (greedy decoding regenerates the
    lost tail bit-exactly), and one with none is simply resubmitted at
    its original arrival time;
  * **degradation** — a frozen (suspect) instance keeps its device state,
    so its *queued* GTs are evacuated by real KV re-migration while its
    running batch waits for the thaw;
  * **deadline watchdog / shedding** — ``RecoveryConfig.deadline_factor``
    aborts requests a multiple past their SLO deadline;
    ``RecoveryConfig.shed`` fast-fails admissions whose projected finish
    already misses it (typed ``RequestShed``).

``repro_torch.cluster.faults.check_fleet_invariants`` audits the terminal
exactly-once + zero-leak contract after any run, chaotic or not.

This is the PyTorch port of ``repro.cluster.fleet``: everything but the
weights' construction and the device follows the reference line for line.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.predictor import apply_padding, bucketize
from repro_torch.core.request import Request
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsRegistry, MetricsSampler
from repro_torch.serving import GenRequest, RequestShed, ServingEngine
from repro_torch.serving.engine import resolve_device, serve_stream

from .autoscale import GoodputAutoscaler
from .base import (DetectorConfig, FailureDetector, HEALTH_STATES,
                   HEALTHY, SUSPECT, InstanceBase, ROLES,
                   execute_autoscale, validate_roles)
from .faults import FaultInjector, RecoveryConfig, backoff_delay
from .hedge import HedgeConfig, HedgeCoordinator
from .router import Router, make_router
from .transport import CANCEL, INJECT, SUBMIT, Transport

__all__ = ["EngineFleet", "FleetInstance", "ROLES"]


class FleetInstance(InstanceBase):
    """One engine plus its routing-visible stats (InstanceStats)."""

    def __init__(self, iid: int, engine: ServingEngine,
                 role: str = "unified"):
        super().__init__(iid, role)
        self.engine = engine

    @property
    def scheduler(self):
        return self.engine.scheduler

    def squeeze_kvc(self, frac: float) -> int:
        # the engine defers a mid-megastep cut to the window boundary
        return self.engine.squeeze_kvc(frac)


class EngineFleet:
    def __init__(self, cfg: ModelConfig, n_instances: int = 2, *,
                 roles: Optional[Sequence[str]] = None,
                 router: str = "least-kvc", seed: int = 0,
                 kv_migration: bool = True,
                 autoscaler: Optional[GoodputAutoscaler] = None,
                 faults: Optional[FaultInjector] = None,
                 recovery: Optional[RecoveryConfig] = None,
                 detector: Optional[DetectorConfig] = None,
                 hedge: Optional[HedgeConfig] = None,
                 params: Optional[dict] = None, device=None,
                 **engine_kwargs):
        """``engine_kwargs`` are forwarded to every ``ServingEngine``
        (max_batch, capacity, scheduler_cfg, engine_cfg, ...). ``device``
        ``None`` means the CUDA card (``resolve_device``); ``params``
        ``None`` builds seeded weights there once, shared by every engine.
        ``kv_migration=False`` forces the swap-recompute fallback for every
        migration (the reference path the KV image is tested against).
        Fleet size under autoscaling is bounded by the scaler's
        ``AutoscaleConfig.max_instances``. ``faults=None`` (the default)
        leaves every fault-tolerance path dormant: no injector polls, no
        recovery bookkeeping touches the hot loop.

        ``detector`` switches the fleet from *declared* to *detected*
        failure: every routed message (submit / KV inject) travels
        through a seeded lossy :class:`Transport`, instances heartbeat
        through it, and the :class:`FailureDetector` owns observed
        health (missed-beat patience -> suspect, lease expiry -> dead,
        fresh beat -> reinstated). An attached injector stops declaring
        health and merely crashes/freezes instances; its drop/dup/delay
        events open transport fault windows. With no fault events the
        detector-on path is bitwise-identical to the direct path: beats
        are pure host-side bookkeeping and the transport delivers
        same-tick FIFO.

        ``hedge`` enables straggler-aware hedged execution (needs
        detector mode): a per-request progress watchdog launches a clone
        of a stalled (or suspect-hosted) request on the best live peer;
        the first terminal transition wins and the loser is cancelled
        through the megastep-safe abort path, its host fenced so a late
        completion is counted, never double-delivered. With
        ``hedge=None`` (or ``HedgeConfig(enabled=False)``) every hedging
        path is dormant and the fleet is bitwise-unchanged."""
        self.cfg = cfg
        self.kv_migration = kv_migration
        self.engine_kwargs = dict(engine_kwargs)
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model.init(cfg, gen, self.device)
        self.params = params
        self._seed = seed
        roles = validate_roles(roles, n_instances)
        self.instances: List[FleetInstance] = [
            FleetInstance(i, self._make_engine(i), roles[i])
            for i in range(n_instances)]
        self.router: Router = make_router(router, seed)
        self.decode_router: Router = make_router(router, seed + 1)
        self.autoscaler = autoscaler
        self.faults = faults
        self.recovery = recovery or RecoveryConfig()
        # detection-and-delivery substrate (None = legacy direct calls)
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
        if self.recovery.shed_retry:
            for inst in self.instances:
                inst.engine.fleet_shed_handback = True
        # at-least-once delivery epochs: each intentional (re)delivery of
        # a GenRequest gets a fresh key; transport dups share the key and
        # are suppressed at the engine boundary
        self._epoch: Dict[int, int] = {}
        # conservation accounting: a GenRequest is routed exactly once
        self.route_of: Dict[int, int] = {}       # id(GenRequest) -> iid
        self.submitted: List[GenRequest] = []
        self.double_routes = 0
        self.n_migrations = 0
        self.n_kv_fallbacks = 0
        self._metrics_registry = None
        self.scale_events: List[Tuple[float, int]] = []
        self._next_id = n_instances
        # crash recovery state
        self._redeliver: List[Tuple[float, GenRequest]] = []
        self._retries: Dict[int, int] = {}       # id(GenRequest) -> attempts
        self._dead_handled: set = set()          # instance ids reclaimed
        # host-pool KV images harvested off dead engines, keyed by
        # id(GenRequest): redelivery re-seeds pages instead of recomputing
        self._salvaged: Dict[int, dict] = {}
        self.n_salvaged_restores = 0
        self.n_recovered = 0
        self.n_failed_recoveries = 0
        self.n_evacuations = 0
        self.n_shed = 0
        self.n_deadline_aborts = 0
        # shed-retry tier: rung-4 kvc-infeasible hand-backs re-routed
        # fleet-wide instead of shed terminally
        self._shed_origin: set = set()   # id(GenRequest) in the retry tier
        self.n_shed_reroutes = 0         # hand-backs requeued for re-route
        self.n_shed_rescued = 0          # delivered to a feasible peer
        # hedged execution (straggler racing with first-winner fencing)
        self.hedge = HedgeCoordinator(hedge) if hedge is not None else None
        if self.hedge is not None:
            assert detector is not None, \
                "hedging needs detector mode (transport + observed health)"
        self._hedge_live: Dict[int, GenRequest] = {}   # gid -> primary g
        # gid -> (clone GenRequest, clone iid, primary iid at launch)
        self._hedge_clone: Dict[int, Tuple[GenRequest, int, int]] = {}
        self._hedge_seq = 0              # coordinator epoch source
        # registration-detach fences: the loser engine's registration is
        # swapped to a private clone, so its late drains/completions land
        # on a record the client never sees (counted, never delivered)
        self._fences: List[Tuple[int, int, GenRequest]] = []
        self.n_fenced_completions = 0
        self.n_stale_drops = 0           # stale-epoch deliveries fenced

    def _make_engine(self, i: int) -> ServingEngine:
        return ServingEngine(self.cfg, params=self.params,
                             seed=self._seed + i, device=self.device,
                             **self.engine_kwargs)

    # ------------------------------------------------------------------ #
    def submit(self, req: GenRequest, now: float) -> int:
        """Route and submit one request; returns the serving instance id.
        Raises ``RequestShed`` (after recording the terminal state) when
        admission control projects an unavoidable SLO miss, or when no
        live instance exists to serve it."""
        if id(req) in self.route_of:
            self.double_routes += 1
        cands = [i for i in self.instances if i.accepts_prompts()]
        if not cands:
            cands = [i for i in self.instances
                     if i.alive and i.role in ("unified", "prefill")]
        if not cands:
            return self._shed(req, now, "no-live-instance")
        demand = len(req.prompt) + req.params.max_new_tokens
        inst = self.router.choose(cands, demand)
        if self.recovery.shed and req.deadline != float("inf"):
            # projected finish on the chosen instance, on the fleet's
            # iteration clock: drain the backlog (~1 token/slot/iter),
            # then produce this request's own tokens
            backlog = inst.outstanding_tokens() / max(1, inst.engine.max_batch)
            eta = now + (backlog + len(req.prompt) / 64.0
                         + req.params.max_new_tokens) \
                * self.recovery.shed_headroom
            if eta > req.deadline:
                return self._shed(req, now, "projected-slo-miss")
        if self.transport is not None:
            # routed decision is made here; the delivery itself rides the
            # (lossy) transport — a clean link delivers synchronously in
            # the pump below (bit-for-bit the direct path), a faulted one
            # leaves it in flight for a later tick's sweep
            inst.engine.validate(req)
            self.transport.send(inst.id, SUBMIT, (req, now), now,
                                dkey=self._dkey(req))
            self._pump(inst, now)
        else:
            inst.engine.submit(req, now)
        self.route_of[id(req)] = inst.id
        self.submitted.append(req)
        if self.hedge is not None and self.hedge.cfg.enabled:
            self.hedge.track(id(req), now)
            self._hedge_live[id(req)] = req
        return inst.id

    def _dkey(self, g: GenRequest) -> tuple:
        """Fresh delivery key (epoch) for one intentional (re)delivery."""
        ep = self._epoch.get(id(g), 0) + 1
        self._epoch[id(g)] = ep
        return (id(g), ep)

    def _shed(self, req: GenRequest, now: float, reason: str) -> int:
        req.t_submit = now
        req.status = "shed"
        req.fail_reason = reason
        self.submitted.append(req)
        self.n_shed += 1
        raise RequestShed(req, reason)

    def _steppable(self, inst: FleetInstance) -> bool:
        """Instances the fleet still advances: every live one, plus
        *detected* DEAD instances that never crashed — zombies (e.g.
        partitioned away from the control plane) keep stepping their
        fenced work until the heal reconciles them."""
        return inst.alive or (inst.detected and not inst.crashed)

    def has_work(self) -> bool:
        return (any(self._steppable(i) and i.engine.has_work()
                    for i in self.instances)
                or bool(self._redeliver)
                or any(i.engine.shed_handback for i in self.instances)
                or (self.transport is not None
                    and self.transport.pending() > 0))

    # ------------------------------------------------------------------ #
    def step(self, now: Optional[float] = None) -> int:
        """One fleet tick: inject scheduled faults, run heartbeat/lease
        detection and deliver in-flight transport messages, reclaim and
        redeliver crashed work, enforce deadlines, step every live engine
        with work, sweep rung-4 shed hand-backs into the retry tier, then
        migrate finished prompts off prefill-role engines. Returns
        completions."""
        now = time.monotonic() if now is None else now
        if self.faults is not None:
            self.faults.poll(now, self.instances)
        if self.detector is not None:
            for inst in self.instances:
                inst.maybe_beat(self.transport, now,
                                self.detector.cfg.beat_every)
            self.detector.observe(now, self.instances)
            self._deliver_transport(now)
        self._reclaim_dead(now)
        if self._redeliver:
            self._deliver_redeliveries(now)
        if self.recovery.deadline_factor > 0:
            self._enforce_deadlines(now)
        done = 0
        for inst in self.instances:
            inst.update_health(now)
            if self._steppable(inst) and inst.engine.has_work() \
                    and inst.can_step(now):
                done += inst.engine.step(now)
        if self.hedge is not None and self.hedge.cfg.enabled:
            self._hedge_tick(now)
        if self._fences:
            self._sweep_fences(now)
        if self.recovery.shed_retry:
            self._retry_sheds(now)
        for inst in self.instances:
            if not inst.alive or inst.crashed:
                continue
            if inst.role == "prefill" and inst.health == HEALTHY:
                self._migrate_ready(inst, now)
            elif inst.health == SUSPECT and now < inst.frozen_until:
                # frozen-but-reachable: evacuate queued GTs by real KV
                # re-migration so they decode elsewhere during the outage
                self._evacuate(inst, now)
        if self.autoscaler is not None:
            self._autoscale(now)
        return done

    # -- transport delivery / shed-retry tier ---------------------------- #
    def _deliver_transport(self, now: float) -> None:
        for inst in self.instances:
            self._pump(inst, now)

    def _pump(self, inst: FleetInstance, now: float) -> None:
        """Drain one instance's due in-flight messages. Senders pump the
        recipient right after ``transport.send`` — a clean link delivers
        synchronously, reproducing the direct-call path bit-for-bit —
        and the per-tick sweep picks up delayed/retransmitted copies. A
        message landing on an instance already declared dead is
        orphaned: if the fleet still thinks the request lives there it
        re-enters recovery; stale copies of work re-routed since
        (fencing) are dropped."""
        for msg in self.transport.recv(inst.id, now):
            if msg.kind == CANCEL:
                # fencing reclaim: abort the (possibly clone-swapped)
                # registration so KVC/slot/ring state is provably freed.
                # Handled before the alive check — a zombie's engine is
                # exactly who a partition-held cancel reconciles at heal.
                # Idempotent (abort of a terminal rid is a no-op) and
                # pointless on a crashed device.
                if not inst.crashed:
                    rid, reason = msg.payload
                    inst.engine.abort(rid, now, reason)
                continue
            if msg.kind == SUBMIT:
                g, t_arr = msg.payload
            else:
                g, t_arr = msg.payload["gen"], now
            if g.finished:
                # terminal while this copy was in flight (redelivery
                # fast path, deadline abort, hedge winner): fenced here,
                # never registered
                continue
            if msg.dkey is not None \
                    and msg.dkey[1] < self._epoch.get(id(g), 0):
                # stale epoch: the fleet intentionally re-delivered this
                # request since the copy was sent (re-route past a
                # partition, hedge fencing) — the old copy must never
                # race the new registration
                self.n_stale_drops += 1
                continue
            if not inst.alive:
                if (not g.finished
                        and self.route_of.get(id(g)) == inst.id
                        and not any(q is g for _, q in self._redeliver)
                        and (self.hedge is None
                             or not self.hedge.active(id(g)))):
                    if (msg.kind == INJECT
                            and msg.payload.get("kv") is not None):
                        # the image in flight is as salvageable as a
                        # host-pool one: restore instead of recompute
                        self._salvaged[id(g)] = {
                            "kv": msg.payload["kv"],
                            "ctx": msg.payload["ctx"],
                            "crc": msg.payload.get("kv_crc")}
                    self._requeue(g, now, "undeliverable")
                continue
            if msg.kind == SUBMIT:
                inst.engine.submit(g, t_arr, dkey=msg.dkey)
            else:
                inst.engine.inject_kv(msg.payload, now)

    def _retry_sheds(self, now: float) -> None:
        """Sweep rung-4 ``kvc-infeasible`` hand-backs into the fleet
        retry tier: a request whose frozen exact-alloc demand some live
        peer's total KVC can still fund is requeued for a router-level
        re-route (bounded retries + the existing jittered backoff); one
        no live peer can *ever* fit is shed terminally — same contract,
        decided fleet-globally instead of per-instance."""
        for inst in self.instances:
            if not inst.engine.shed_handback:
                continue
            handed, inst.engine.shed_handback = \
                inst.engine.shed_handback, []
            for g in handed:
                self._shed_origin.add(id(g))
                demand = len(g.prompt) + g.params.max_new_tokens
                if any(i.alive and i.scheduler.fits_ever(demand)
                       for i in self.instances):
                    self.n_shed_reroutes += 1
                    self._requeue(g, now, "kvc-infeasible")
                else:
                    self._shed_terminal(g)

    def _shed_terminal(self, g: GenRequest) -> None:
        g.status = "shed"
        g.fail_reason = "kvc-infeasible"
        self.n_shed += 1
        self._salvaged.pop(id(g), None)

    # -- crash recovery ------------------------------------------------- #
    def _reclaim_dead(self, now: float) -> None:
        """Sweep newly-dead instances: every non-terminal request they
        held is queued for redelivery (bounded retries + backoff). The
        dead engine's undrained ring tokens are dropped — device state is
        gone; greedy recompute regenerates them bit-exactly."""
        for inst in self.instances:
            if inst.alive or inst.id in self._dead_handled:
                continue
            self._dead_handled.add(inst.id)
            if inst.detected and not inst.crashed:
                # declared dead but still stepping: a zombie (partition,
                # or a false death from lost beats). Its device state is
                # intact and must NOT be touched — fence instead.
                self._reclaim_zombie(inst, now)
                continue
            eng = inst.engine
            eng._pending_drain.clear()       # ring state died with the device
            victims = [g for g in eng.requests.values() if not g.finished]
            # host-offloaded KV images outlive the device: harvest them so
            # redelivery restores pages instead of recomputing
            for rid, img in eng._host_swap.items():
                g = eng.requests.get(rid)
                if g is not None and not g.finished:
                    self._salvaged[id(g)] = img
            eng._host_swap.clear()
            for payload, _ in eng._pending_injects:   # migrated in, unapplied
                if not payload["gen"].finished:
                    victims.append(payload["gen"])
                    if payload.get("kv") is not None:
                        # an in-flight KV image is just as salvageable
                        self._salvaged[id(payload["gen"])] = {
                            "kv": payload["kv"], "ctx": payload["ctx"],
                            "crc": payload.get("kv_crc")}
            eng._pending_injects.clear()
            eng._pending_aborts.clear()
            for g in victims:
                self._requeue(g, now, "crash")
            if self.autoscaler is not None:
                self.autoscaler.invalidate()

    def _reclaim_zombie(self, inst: FleetInstance, now: float) -> None:
        """Reconcile an instance the detector declared dead while its
        device kept running (asymmetric partition: outbound beats lost,
        the engine none the wiser). Every fleet-routed request on it is
        *fenced* — the engine's registration is swapped to a private
        clone, so the zombie's late drains/completions land on a record
        the client never sees — and a CANCEL rides the transport to
        reclaim the clone's KVC/slot/ring: a partitioned link holds it
        until the heal, which is exactly when the zombie becomes
        reachable again. Fenced requests re-enter recovery unless a
        hedge clone is already racing for them (the clone *is* the
        recovery)."""
        eng = inst.engine
        victims = [g for g in eng.requests.values()
                   if not g.finished
                   and self.route_of.get(id(g)) == inst.id]
        for payload, _ in eng._pending_injects:
            pg = payload.get("gen")
            if (pg is not None and not pg.finished
                    and self.route_of.get(id(pg)) == inst.id
                    and all(pg is not v for v in victims)):
                victims.append(pg)
        for g in victims:
            registered = eng.requests.get(g.rid) is g
            self._fence_registration(inst, g)
            if registered:
                self.transport.send(inst.id, CANCEL,
                                    (g.rid, "fenced-zombie"), now)
                self._pump(inst, now)
            if self.hedge is not None and self.hedge.active(id(g)):
                continue          # racing clone is the recovery path
            self._requeue(g, now, "partition")
        if victims and self.autoscaler is not None:
            self.autoscaler.invalidate()

    def _fence_registration(self, inst: FleetInstance,
                            g: GenRequest) -> None:
        """Detach ``g`` from ``inst``'s engine by swapping the
        registration (and any unapplied inject payload) to a private
        clone seeded with the drained-so-far output. The engine keeps
        running undisturbed — its device state still maps rid to a live
        request — but every subsequent drain/terminal write lands on the
        clone, which ``_sweep_fences`` counts and discards. This is the
        first-winner fence: the client-visible record can no longer be
        written by the losing side."""
        eng = inst.engine
        if eng.requests.get(g.rid) is g:
            clone = GenRequest(prompt=g.prompt, params=g.params,
                               rid=g.rid, output=list(g.output),
                               t_submit=g.t_submit, deadline=g.deadline)
            eng.requests[g.rid] = clone
            self._fences.append((inst.id, g.rid, clone))
        for payload, _ in eng._pending_injects:
            if payload.get("gen") is g:
                clone = GenRequest(prompt=g.prompt, params=g.params,
                                   output=list(g.output),
                                   t_submit=g.t_submit,
                                   deadline=g.deadline)
                payload["gen"] = clone
                self._fences.append((inst.id, -1, clone))

    def _sweep_fences(self, now: float) -> None:
        """Count completions that landed on fence clones — the loser's
        late terminal transitions, observed but never delivered (the
        invariant the partition chaos exists to stress: counted, not
        double-delivered). Aborted clones (the CANCEL landed first)
        simply retire."""
        still: List[Tuple[int, int, GenRequest]] = []
        for iid, rid, clone in self._fences:
            if not clone.finished:
                still.append((iid, rid, clone))
            elif clone.status == "completed" or clone.t_done is not None:
                self.n_fenced_completions += 1
                if self.hedge is not None:
                    self.hedge.n_fenced += 1
        self._fences = still

    # -- hedged execution ------------------------------------------------ #
    def _inst(self, iid: int) -> Optional[FleetInstance]:
        for i in self.instances:
            if i.id == iid:
                return i
        return None

    def _hedge_tick(self, now: float) -> None:
        """Per-tick hedge pass: feed host-visible progress to the
        watchdog, launch clones for stalled / suspect-hosted requests,
        and resolve races on the first terminal transition."""
        hedge = self.hedge
        for gid, g in list(self._hedge_live.items()):
            racing = self._hedge_clone.get(gid)
            if racing is None:
                hedge.observe_progress(gid, len(g.output), now)
                if g.finished:
                    hedge.mark_terminal(gid)
                    del self._hedge_live[gid]
                    continue
                primary = self._inst(self.route_of.get(gid, -1))
                suspect = primary is not None \
                    and primary.health != HEALTHY
                reason = hedge.want_hedge(gid, now, host_suspect=suspect)
                if reason is not None \
                        and not any(q is g for _, q in self._redeliver):
                    self._launch_hedge(g, primary, reason, now)
                continue
            clone, ciid, piid = racing
            ci = self._inst(ciid)
            if g.finished:
                # primary side won (completion, deadline abort, or the
                # redelivery fast path): cancel the clone, megastep-safe
                hedge.resolve(gid, "primary", piid)
                if ci is not None and not ci.crashed and clone.rid >= 0:
                    ci.engine.abort(clone.rid, now, "hedge-lost")
                del self._hedge_clone[gid]
                del self._hedge_live[gid]
                hedge.mark_terminal(gid)
                continue
            clone_dead = clone.rid < 0 and (ci is None or not ci.alive)
            if clone.finished and (clone.status == "completed"
                                   or clone.t_done is not None):
                # clone won: fence the primary registration FIRST (its
                # engine may be mid-window and must not write g again),
                # then publish the winning stream and cancel the loser
                pi = self._inst(piid)
                primary_rid = g.rid
                was_registered = (pi is not None
                                  and pi.engine.requests.get(g.rid) is g)
                if pi is not None:
                    self._fence_registration(pi, g)
                hedge.resolve(gid, "clone", piid)
                g.output[:] = clone.output
                g.status = "completed"
                g.t_done = clone.t_done
                self.route_of[gid] = ciid
                if was_registered and not pi.crashed:
                    self.transport.send(piid, CANCEL,
                                        (primary_rid, "hedge-lost"), now)
                    self._pump(pi, now)
                del self._hedge_clone[gid]
                del self._hedge_live[gid]
                continue
            if clone.finished or clone_dead:
                # clone died without completing (deadline abort, host
                # crash, undeliverable): dissolve the race — the primary
                # keeps running; if it no longer serves the request
                # (zombie-fenced meanwhile), recovery takes over
                hedge.abandon(gid)
                del self._hedge_clone[gid]
                pi = self._inst(piid)
                if (pi is None
                        or pi.engine.requests.get(g.rid) is not g) \
                        and not any(q is g for _, q in self._redeliver):
                    self._requeue(g, now, "hedge-failed")

    def _launch_hedge(self, g: GenRequest,
                      primary: Optional[FleetInstance], reason: str,
                      now: float) -> None:
        """Race ``g`` on the best live peer (router-scored, skipping the
        primary) under a fresh delivery epoch. The clone is a private
        ``GenRequest`` seeded with the drained-so-far prefix and rides
        the existing inject-recompute path — greedy decoding makes its
        stream bitwise-equal to the fault-free one."""
        piid = -1 if primary is None else primary.id
        cands = [i for i in self.instances
                 if i.accepts_prompts() and i.id != piid]
        if not cands:
            return
        out = list(g.output)
        rl = g.params.max_new_tokens
        eos = g.params.eos_token
        if eos is not None and eos in out:
            rl = out.index(eos) + 1
        if len(out) >= rl:
            return                   # drained tail already complete
        demand = len(g.prompt) + rl - len(out)
        tgt = self.router.choose(cands, demand)
        clone = GenRequest(prompt=g.prompt, params=g.params, output=out,
                           t_submit=g.t_submit, deadline=g.deadline)
        self._hedge_seq += 1
        self.hedge.launch(id(g), (self._hedge_seq,), tgt.id, reason)
        self._hedge_clone[id(g)] = (clone, tgt.id, piid)
        if out:
            r = Request(rid=-1, prompt_len=len(g.prompt), true_rl=rl,
                        arrival=g.t_submit, slo_deadline=g.deadline)
            r.generated = len(out)
            r.prompt_done = r.prompt_len
            r.n_preemptions = 1
            r.predicted_rl = tgt.engine.predictor.predict(r)
            scfg = tgt.engine.scheduler.cfg
            r.padded_rl = apply_padding(r.predicted_rl, scfg.pad_ratio,
                                        scfg.bucket)
            if r.padded_rl <= r.generated:
                r.padded_rl = bucketize(r.generated + scfg.bucket,
                                        scfg.bucket)
            payload = {"gen": clone, "req": r, "kv": None,
                       "ctx": len(g.prompt) + len(out) - 1,
                       "last_tok": out[-1], "kv_crc": None,
                       "dkey": self._dkey(clone)}
            self.transport.send(tgt.id, INJECT, payload, now,
                                dkey=payload["dkey"])
            self._pump(tgt, now)
        else:
            self.transport.send(tgt.id, SUBMIT, (clone, now), now,
                                dkey=self._dkey(clone))
            self._pump(tgt, now)

    def _requeue(self, g: GenRequest, now: float, reason: str) -> None:
        att = self._retries.get(id(g), 0)
        if att >= self.recovery.max_retries:
            if id(g) in self._shed_origin:
                self._shed_terminal(g)   # retry tier exhausted: shed, not
                return                   # aborted — exactly-once terminal
            g.status = "aborted"
            g.fail_reason = f"retries-exhausted({reason})"
            self.n_failed_recoveries += 1
            self._salvaged.pop(id(g), None)
            return
        self._retries[id(g)] = att + 1
        delay = backoff_delay(self.recovery, g.rid, att)
        self._redeliver.append((now + delay, g))

    def _deliver_redeliveries(self, now: float) -> None:
        due = [(t, g) for t, g in self._redeliver if t <= now]
        if not due:
            return
        self._redeliver = [(t, g) for t, g in self._redeliver if t > now]
        for _, g in due:
            if g.finished:               # aborted while waiting (deadline)
                self._salvaged.pop(id(g), None)
                continue
            out, eos = g.output, g.params.eos_token
            rl = g.params.max_new_tokens
            if eos is not None and eos in out:
                rl = out.index(eos) + 1
            if len(out) >= rl:
                # everything needed was already drained before the crash
                del out[rl:]
                g.status = "completed"
                g.t_done = now
                self.n_recovered += 1
                self._salvaged.pop(id(g), None)
                continue
            cands = [i for i in self.instances if i.accepts_prompts()] \
                or [i for i in self.instances if i.alive and not i.draining] \
                or [i for i in self.instances if i.alive]
            if not cands:
                self._requeue(g, now, "no-live-instance")  # burns a retry
                continue
            if id(g) in self._shed_origin:
                # shed-retry tier: route only to a peer whose total KVC
                # can fund the frozen exact-alloc demand; if none exists
                # anywhere alive, the shed becomes terminal after all
                total = len(g.prompt) + rl
                fits = [i for i in cands if i.scheduler.fits_ever(total)]
                if not fits:
                    if any(i.alive and i.scheduler.fits_ever(total)
                           for i in self.instances):
                        self._requeue(g, now, "kvc-infeasible")
                    else:
                        self._shed_terminal(g)
                    continue
                cands = fits
                self.n_shed_rescued += 1
            demand = len(g.prompt) + rl - len(out)
            tgt = self.router.choose(cands, demand)
            if out:
                # re-seed through the swap-recompute inject path: the
                # receiver re-prefills prompt + generated-so-far and
                # continues decoding from the last drained token
                r = Request(rid=-1, prompt_len=len(g.prompt), true_rl=rl,
                            arrival=g.t_submit, slo_deadline=g.deadline)
                r.generated = len(out)
                r.prompt_done = r.prompt_len
                r.n_preemptions = 1      # recovery is a forced preemption
                r.predicted_rl = tgt.engine.predictor.predict(r)
                scfg = tgt.engine.scheduler.cfg
                r.padded_rl = apply_padding(r.predicted_rl, scfg.pad_ratio,
                                            scfg.bucket)
                if r.padded_rl <= r.generated:
                    r.padded_rl = bucketize(r.generated + scfg.bucket,
                                            scfg.bucket)
                payload = {"gen": g, "req": r, "kv": None,
                           "ctx": len(g.prompt) + len(out) - 1,
                           "last_tok": out[-1], "kv_crc": None}
                # a salvaged host-pool image whose extent matches the
                # drained tail restores pages instead of recomputing;
                # a mismatch (undrained ring tokens died with the
                # device) falls back — the recompute path regenerates
                # them bit-exactly
                img = self._salvaged.pop(id(g), None)
                if (img is not None and img.get("kv") is not None
                        and img["ctx"] == payload["ctx"]):
                    payload["kv"] = img["kv"]
                    payload["kv_crc"] = img.get("crc")
                    self.n_salvaged_restores += 1
                if self.faults is not None:
                    payload = self.faults.corrupt_payload(payload)
                if self.transport is not None:
                    payload["dkey"] = self._dkey(g)
                    self.transport.send(tgt.id, INJECT, payload, now,
                                        dkey=payload["dkey"])
                    self._pump(tgt, now)
                else:
                    tgt.engine.inject_kv(payload, now)
            else:
                self._salvaged.pop(id(g), None)
                if self.transport is not None:
                    self.transport.send(tgt.id, SUBMIT, (g, g.t_submit),
                                        now, dkey=self._dkey(g))
                    self._pump(tgt, now)
                else:
                    tgt.engine.submit(g, g.t_submit)
            self.route_of[id(g)] = tgt.id    # re-route, not a double route
            self.n_recovered += 1
            if self.hedge is not None and self.hedge.cfg.enabled:
                # re-arm the stall clocks: the new host deserves a full
                # threshold window before being called a straggler
                self.hedge.reset_progress(id(g), len(g.output), now)

    # -- deadline watchdog ---------------------------------------------- #
    def _enforce_deadlines(self, now: float) -> None:
        k = self.recovery.deadline_factor
        for inst in self.instances:
            if not inst.alive:
                continue
            for g in list(inst.engine.requests.values()):
                if g.finished or g.deadline == float("inf"):
                    continue
                if now > g.t_submit + k * (g.deadline - g.t_submit):
                    if inst.engine.abort(g.rid, now, "deadline"):
                        self.n_deadline_aborts += 1
        kept = []
        for t, g in self._redeliver:
            if (not g.finished and g.deadline != float("inf")
                    and now > g.t_submit + k * (g.deadline - g.t_submit)):
                g.status = "aborted"
                g.fail_reason = "deadline"
                self.n_deadline_aborts += 1
            else:
                kept.append((t, g))
        self._redeliver = kept

    # -- migration / evacuation ----------------------------------------- #
    def _decode_targets(self, exclude_id: int = -1) -> List[FleetInstance]:
        cands = [i for i in self.instances
                 if i.accepts_decodes() and i.id != exclude_id]
        if not cands:
            cands = [i for i in self.instances
                     if i.health == HEALTHY
                     and i.role in ("unified", "decode")
                     and i.id != exclude_id]
        return cands

    def _transfer(self, src: FleetInstance, r, tgt: FleetInstance,
                  now: float) -> None:
        payload = src.engine.export_kv(r.rid)
        if not self.kv_migration:
            payload["kv"] = None
        if self.faults is not None:
            payload = self.faults.corrupt_payload(payload)
        if payload["kv"] is None:
            self.n_kv_fallbacks += 1
        if self.transport is not None:
            payload["dkey"] = self._dkey(payload["gen"])
            self.transport.send(tgt.id, INJECT, payload, now,
                                dkey=payload["dkey"])
            self._pump(tgt, now)
        else:
            tgt.engine.inject_kv(payload, now)
        self.route_of[id(payload["gen"])] = tgt.id

    def _migrate_ready(self, inst: FleetInstance, now: float) -> None:
        """Move every queued GT off a prefill engine to a decode engine."""
        if inst.engine._mega_left > 0:
            # only possible when a prior tick had no live decode target and
            # the stranded GTs started decoding here; wait for the window
            return
        sched = inst.engine.scheduler
        for r in list(sched.gt_queue):
            cands = self._decode_targets()
            if not cands:
                return                   # no live receiver; retry next tick
            demand = r.prompt_len + r.remaining_predicted
            tgt = self.decode_router.choose(cands, demand)
            self._transfer(inst, r, tgt, now)
            self.n_migrations += 1

    def _evacuate(self, inst: FleetInstance, now: float) -> None:
        """Drain a frozen instance's *queued* GTs to healthy peers via
        real KV re-migration (its device state is intact, just slow to
        schedule); the running batch rides out the freeze in place."""
        if inst.engine._mega_left > 0:
            return                       # window open: state not exportable
        sched = inst.engine.scheduler
        for r in list(sched.gt_queue):
            cands = self._decode_targets(exclude_id=inst.id)
            if not cands:
                return
            demand = r.prompt_len + r.remaining_predicted
            tgt = self.decode_router.choose(cands, demand)
            self._transfer(inst, r, tgt, now)
            self.n_evacuations += 1

    # ------------------------------------------------------------------ #
    def _spawn(self, now: float) -> None:
        iid = self._next_id
        self._next_id += 1
        inst = FleetInstance(iid, self._make_engine(iid), "unified")
        if self._metrics_registry is not None:
            MetricsSampler(self._metrics_registry,
                           instance=str(iid)).attach(inst.engine)
        if self.detector is not None:
            inst.detected = True
        if self.recovery.shed_retry:
            inst.engine.fleet_shed_handback = True
        self.instances.append(inst)

    def _autoscale(self, now: float) -> None:
        scaler = self.autoscaler
        # harvest fresh completions for the attainment window
        for inst in self.instances:
            inst.harvest_completions(scaler)
        execute_autoscale(scaler, now, self.instances, self._spawn,
                          self.scale_events)

    # ------------------------------------------------------------------ #
    def run(self, gen_requests: Sequence[GenRequest],
            arrivals: Optional[Sequence[float]] = None,
            max_steps: int = 100_000,
            stall_limit: int = 2_000) -> List[GenRequest]:
        """Serve a batch (or, with ``arrivals``, an online stream on the
        fleet's iteration clock) to completion — the same contract as
        ``ServingEngine.run``, one shared driver."""
        return serve_stream(self, gen_requests, arrivals, max_steps,
                            stall_limit)

    def flush(self) -> None:
        for inst in self.instances:
            if self._steppable(inst):   # zombies drain their fences too
                inst.engine.flush()
        if self._fences:
            self._sweep_fences(0.0)

    # -- liveness / diagnostics ----------------------------------------- #
    def progress_state(self) -> tuple:
        """Monotone fleet fingerprint for the ``serve_stream`` watchdog."""
        insts = tuple((i.id, i.health, i.engine.progress_state())
                      for i in self.instances)
        term = sum(1 for g in self.submitted if g.finished)
        return (insts, term, self.n_migrations, self.n_recovered,
                self.n_evacuations, len(self._redeliver),
                self.n_shed, self.n_shed_reroutes, self.n_shed_rescued,
                0 if self.transport is None else self.transport.pending(),
                0 if self.detector is None
                else len(self.detector.transitions),
                self.n_fenced_completions, len(self._fences),
                0 if self.hedge is None
                else (self.hedge.n_fired, self.hedge.n_won,
                      self.hedge.n_cancelled))

    def attach_metrics(self, registry) -> None:
        """Attach a per-iteration ``MetricsSampler`` to every engine
        (instances spawned later by the autoscaler are attached in
        ``_spawn``). Sampling follows the zero-sync contract: device
        values come only from the lag-N drain ring, host values at the
        step boundary the engine already takes."""
        self._metrics_registry = registry
        for inst in self.instances:
            MetricsSampler(registry,
                           instance=str(inst.id)).attach(inst.engine)

    def publish_metrics(self, registry) -> None:
        """Publish the whole fleet — every engine (instance-labelled),
        instance lifecycle state, routers, fault-tolerance counters,
        transport and detector — into one ``repro_torch.obs`` registry. This
        is the single publication path behind ``debug_state`` and the
        ``--metrics`` exit dumps."""
        health_g = registry.gauge(
            "fleet_instance_health", "observed health: healthy=0 "
            "suspect=1 dead=2", ("instance",))
        role_g = registry.gauge(
            "fleet_instance_state", "per-instance lifecycle flags",
            ("instance", "flag"))
        for inst in self.instances:
            inst.engine.publish_metrics(registry, instance=str(inst.id))
            health_g.labels(instance=inst.id).set(
                HEALTH_STATES.index(inst.health))
            role_g.labels(instance=inst.id,
                          flag="draining").set(int(inst.draining))
            role_g.labels(instance=inst.id,
                          flag="crashed").set(int(inst.crashed))

        def c(name, help, value):
            registry.counter(name, help).unlabeled.inc_to(value)

        c("fleet_migrations_total", "KV migrations (live image or "
          "recompute fallback)", self.n_migrations)
        c("fleet_kv_fallbacks_total", "migrations that fell back to "
          "swap-recompute", self.n_kv_fallbacks)
        c("fleet_recovered_total", "requests requeued off a dead "
          "instance", self.n_recovered)
        c("fleet_salvaged_restores_total", "redeliveries re-seeded from "
          "a salvaged host-pool image", self.n_salvaged_restores)
        c("fleet_evacuations_total", "queued work evacuated off a "
          "suspect", self.n_evacuations)
        c("fleet_shed_total", "terminal sheds", self.n_shed)
        c("fleet_deadline_aborts_total", "deadline-infeasible aborts",
          self.n_deadline_aborts)
        c("fleet_shed_reroutes_total", "rung-4 hand-backs requeued for "
          "re-route", self.n_shed_reroutes)
        c("fleet_shed_rescued_total", "hand-backs delivered to a "
          "feasible peer", self.n_shed_rescued)
        c("fleet_double_routes_total", "conservation violations (must "
          "stay 0)", self.double_routes)
        c("fleet_fenced_completions_total", "loser-side completions that "
          "landed on a registration fence: counted, never delivered",
          self.n_fenced_completions)
        c("fleet_stale_drops_total", "stale-epoch deliveries fenced at "
          "the pump", self.n_stale_drops)
        if self.hedge is not None:
            self.hedge.publish_metrics(registry)
        registry.gauge("fleet_redeliver_queue_depth",
                       "recoveries awaiting backoff expiry") \
            .unlabeled.set(len(self._redeliver))
        self.router.publish_metrics(registry, side="arrival")
        self.decode_router.publish_metrics(registry, side="decode")
        if self.autoscaler is not None:
            self.autoscaler.publish_metrics(registry)
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
            registry.gauge("transport_pending_messages",
                           "messages in flight") \
                .unlabeled.set(self.transport.pending())
        if self.detector is not None:
            self.detector.publish_metrics(registry, self.instances)

    def debug_state(self) -> Dict[str, object]:
        """Stall post-mortem: per-instance health *as observed* (detected
        mode: heartbeat age + crashed ground truth), fault-tolerance
        counters and in-flight transport/redelivery queues — derived
        from one registry snapshot (the same publication path live
        metrics use), so stall diagnostics and metrics can never
        disagree. The two append-only event logs (fired faults, detector
        transitions) ride along verbatim: they are post-mortem context,
        not scalar samples."""
        reg = MetricsRegistry()
        self.publish_metrics(reg)
        state: Dict[str, object] = dict(reg.snapshot().flat())
        if self.faults is not None:
            state["faults_fired"] = list(self.faults.log)
        if self.detector is not None:
            state["detector_transitions"] = list(self.detector.transitions)
        return state

    # ------------------------------------------------------------------ #
    def completed_requests(self) -> List[Request]:
        """Scheduler-side Request records across all engines (TTFT etc.)."""
        return [r for inst in self.instances
                for r in inst.engine.scheduler.completed]

    def conservation(self) -> Dict[str, int]:
        """Every submitted request reached exactly one terminal state."""
        done = aborted = shed = 0
        for g in self.submitted:
            status = getattr(g, "status", None)
            if status == "completed" or (status is None
                                         and g.t_done is not None):
                done += 1
            elif status == "aborted":
                aborted += 1
            elif status == "shed":
                shed += 1
        pending = len(self.submitted) - done - aborted - shed
        return {"submitted": len(self.submitted),
                "completed": done,
                "aborted": aborted,
                "shed": shed,
                "pending": pending,
                "double_routes": self.double_routes,
                "migrations": self.n_migrations,
                "recovered": self.n_recovered,
                "salvaged": self.n_salvaged_restores,
                "evacuations": self.n_evacuations,
                "kv_rejects": sum(i.engine.n_kv_rejects
                                  for i in self.instances),
                "shed_reroutes": self.n_shed_reroutes,
                "shed_rescued": self.n_shed_rescued,
                "dup_deliveries": sum(i.engine.n_dup_deliveries
                                      for i in self.instances),
                "dup_completions": sum(i.engine.n_dup_completions
                                       for i in self.instances),
                "fenced_completions": self.n_fenced_completions,
                "stale_drops": self.n_stale_drops,
                "hedges_fired": 0 if self.hedge is None
                else self.hedge.n_fired,
                "hedges_won": 0 if self.hedge is None
                else self.hedge.n_won,
                "hedges_cancelled": 0 if self.hedge is None
                else self.hedge.n_cancelled,
                "ok": int(self.double_routes == 0 and pending == 0)}
