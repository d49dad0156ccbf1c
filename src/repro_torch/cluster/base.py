"""Shared cluster-instance layer: roles, router-visible stats, and the
autoscale-decision executor — one implementation for both backends.

``ClusterSim`` instances wrap a discrete-event ``SimInstance`` and
``EngineFleet`` instances wrap a real ``ServingEngine``; everything the
router and autoscaler observe (role eligibility, KVC fractions,
outstanding work) only needs the underlying scheduler, so subclasses
provide a single ``scheduler`` property and inherit the rest. Keeping
this here — not copied per backend — means a policy fix lands in both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .autoscale import GoodputAutoscaler
from .transport import BEAT, DETECTOR, Transport

ROLES = ("unified", "prefill", "decode")

# instance health lifecycle (fault injection / recovery):
#   healthy — routable, stepped normally
#   suspect — alive but degraded (frozen or slowed): no new routes; its
#             in-flight state is intact and reachable, so the fleet may
#             evacuate queued work via real KV re-migration
#   dead    — crashed: device state lost, never stepped or routed again;
#             in-flight requests are reclaimed and recovered elsewhere
#
# With a FailureDetector attached, health is *observed*, not declared:
# the injector only crashes/freezes the instance (it stops heartbeating)
# and the detector walks HEALTHY -> SUSPECT on missed-beat patience and
# SUSPECT -> DEAD on lease expiry. A false suspect that beats again is
# reinstated (SUSPECT -> HEALTHY) with all of its work intact; DEAD is
# final — a late beat from a fenced zombie never resurrects it.
HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
HEALTH_STATES = (HEALTHY, SUSPECT, DEAD)


def validate_roles(roles, n_instances: int) -> List[str]:
    """Normalize + sanity-check a role assignment: a prefill-only fleet
    would ping-pong migrated GTs forever, a decode-only one could never
    admit a prompt."""
    roles = list(roles) if roles is not None else ["unified"] * n_instances
    assert len(roles) == n_instances, (roles, n_instances)
    assert all(r in ROLES for r in roles), roles
    if any(r != "unified" for r in roles):
        assert any(r in ("prefill", "unified") for r in roles) and \
            any(r in ("decode", "unified") for r in roles), \
            "disaggregated cluster needs both prompt and decode capacity"
    return roles


class InstanceBase:
    """Role state + the InstanceStats protocol routers consume."""

    def __init__(self, iid: int, role: str = "unified"):
        assert role in ROLES, role
        self.id = iid
        self.role = role
        self.draining = False
        self._n_done = 0              # completions already fed upstream
        # -- health (fault injection / recovery) ----------------------- #
        self.health = HEALTHY
        self.frozen_until = 0.0       # suspect-frozen: not stepped until t
        self.slow_until = 0.0         # suspect-slow: degraded until t
        self.slow_factor = 1          # straggler slowdown multiple
        self._slow_tick = 0
        # -- detection (heartbeat/lease failure detector) -------------- #
        # ``crashed`` is ground truth (the device is gone: no stepping,
        # no beats); ``health`` stays the *observed* state. Without a
        # detector the injector writes health directly and crashed is
        # never set. ``detected`` hands health ownership to the detector
        # (the freeze-elapsed auto-recovery in update_health turns off).
        self.crashed = False
        self.detected = False
        self._last_beat_sent = float("-inf")

    @property
    def scheduler(self):
        raise NotImplementedError

    # -- health -------------------------------------------------------- #
    @property
    def alive(self) -> bool:
        return self.health != DEAD

    def update_health(self, t: float) -> None:
        """Recover a suspect instance whose freeze/slow episode elapsed.
        Under a failure detector this is a no-op: reinstatement happens
        when the detector sees the instance heartbeat again."""
        if self.detected:
            return
        if self.health == SUSPECT and t >= self.frozen_until \
                and t >= self.slow_until:
            self.health = HEALTHY
            self.slow_factor = 1

    def can_step(self, t: float) -> bool:
        """Whether the backend may advance this instance at time ``t``:
        crashed never, declared-dead (oracle mode) never, frozen not
        before thaw, slowed every Nth tick only. A falsely-*suspected*
        instance (beats lost in transit, not frozen) keeps stepping — it
        loses no work while the detector makes up its mind. A *detected*
        DEAD instance that never crashed is a zombie (e.g. partitioned
        away from the control plane): it cannot know it was declared
        dead, so it keeps stepping too — its output is fenced at the
        delivery boundary, not by freezing the device."""
        if self.crashed or (self.health == DEAD and not self.detected):
            return False
        if self.health == DEAD:
            # zombie: local freeze/slow windows still apply
            if t < self.frozen_until:
                return False
            if t < self.slow_until and self.slow_factor > 1:
                self._slow_tick += 1
                return self._slow_tick % self.slow_factor == 0
            return True
        if self.health == HEALTHY and t < self.frozen_until:
            return False              # detector-managed: frozen, not yet
                                      # suspected — still must not step
        if self.health == HEALTHY and t < self.slow_until \
                and self.slow_factor > 1:
            self._slow_tick += 1
            return self._slow_tick % self.slow_factor == 0
        if self.health == SUSPECT:
            if t < self.frozen_until:
                return False
            if t < self.slow_until and self.slow_factor > 1:
                self._slow_tick += 1
                return self._slow_tick % self.slow_factor == 0
        return True

    def maybe_beat(self, transport: Transport, now: float,
                   beat_every: float) -> None:
        """Emit a heartbeat through the (lossy) transport when one is
        due. A crashed instance is silent forever; a frozen one is silent
        until the thaw — missed beats are exactly what the detector
        observes. A slowed instance still beats (stragglers are not
        crash-detectable from liveness alone)."""
        if self.crashed or now < self.frozen_until:
            return
        if now - self._last_beat_sent >= beat_every - 1e-9:
            self._last_beat_sent = now
            transport.send(DETECTOR, BEAT, self.id, now, link=self.id)

    def squeeze_kvc(self, frac: float) -> int:
        """Chaos ``squeeze``: permanently remove ``frac`` of this
        instance's KVC capacity (free blocks immediately, held blocks
        harvested as allocations free — ``BlockKVC.shrink``). Backends
        with stricter timing contracts (the real engine's megastep
        windows) override to defer the cut to a safe boundary."""
        kvc = self.scheduler.kvc
        return kvc.shrink(int(kvc.capacity_tokens * frac))

    # -- routing eligibility ------------------------------------------- #
    def accepts_prompts(self) -> bool:
        return (self.health == HEALTHY
                and self.role in ("unified", "prefill")
                and not self.draining)

    def accepts_decodes(self) -> bool:
        return (self.health == HEALTHY
                and self.role in ("unified", "decode")
                and not self.draining)

    # -- InstanceStats protocol ---------------------------------------- #
    def kvc_allocated_frac(self) -> float:
        return self.scheduler.kvc.allocated_frac

    def kvc_capacity_tokens(self) -> int:
        return self.scheduler.kvc.capacity_tokens

    def outstanding_tokens(self) -> int:
        sched = self.scheduler
        tot = 0
        for r in sched.pt_queue:
            tot += (r.prompt_len - r.prompt_done) + r.remaining_predicted
        for r in sched.gt_queue:
            tot += r.remaining_predicted
        for r in getattr(sched, "running_gts", []):
            tot += r.remaining_predicted
        return tot

    def harvest_completions(self, scaler: GoodputAutoscaler) -> None:
        """Feed completions since the last harvest into the attainment
        window."""
        done = self.scheduler.completed
        for r in done[self._n_done:]:
            scaler.record(r.met_slo)
        self._n_done = len(done)


@dataclass
class DetectorConfig:
    """Heartbeat/lease failure-detection policy.

    An instance that has not beaten for ``patience`` beat periods is
    suspected (no new routes; work stays put); one silent past ``lease``
    is declared dead and its work reclaimed. ``lease`` must comfortably
    exceed ``patience * beat_every`` — the gap is the reinstatement
    window in which a false suspect (beats dropped by the transport, or
    a freeze shorter than the lease) recovers without losing anything."""
    beat_every: float = 1.0       # expected heartbeat period
    patience: float = 3.0         # missed beats before HEALTHY -> SUSPECT
    lease: float = 10.0           # silence before SUSPECT -> DEAD

    def __post_init__(self):
        assert self.lease > self.patience * self.beat_every, \
            "lease must exceed the suspicion threshold"


class FailureDetector:
    """Detects instance failure from heartbeats instead of being told.

    ``observe`` drains the beat channel and walks each instance's
    *observed* health: silence past patience suspects it, silence past
    the lease declares it dead (final — a zombie's late beat is fenced),
    and a fresh beat from a suspect reinstates it. The transition log is
    append-only and auditable (the Hypothesis state machine in
    ``tests`` checks no transition ever skips a state or resurrects the
    dead)."""

    def __init__(self, cfg: DetectorConfig, transport: Transport):
        self.cfg = cfg
        self.transport = transport
        self.last_beat: Dict[int, float] = {}
        self.last_observed = 0.0
        self.n_suspects = 0
        self.n_reinstated = 0
        self.n_declared_dead = 0
        self.transitions: List[Tuple[float, int, str, str]] = []

    def _set(self, inst, to: str, now: float) -> None:
        self.transitions.append((now, inst.id, inst.health, to))
        inst.health = to

    def observe(self, now: float, instances: Sequence) -> List[int]:
        """One detection pass; returns ids newly declared dead."""
        self.last_observed = now
        for msg in self.transport.recv(DETECTOR, now):
            iid = msg.payload
            if msg.send_t > self.last_beat.get(iid, float("-inf")):
                self.last_beat[iid] = msg.send_t
        newly_dead: List[int] = []
        for inst in instances:
            if inst.health == DEAD:
                continue               # final: never resurrected
            last = self.last_beat.setdefault(inst.id, now)
            age = now - last
            if inst.health == SUSPECT:
                if age <= self.cfg.patience * self.cfg.beat_every:
                    self._set(inst, HEALTHY, now)   # false suspect: back
                    self.n_reinstated += 1
                elif age > self.cfg.lease:
                    self._set(inst, DEAD, now)      # lease expired
                    self.n_declared_dead += 1
                    newly_dead.append(inst.id)
            elif inst.health == HEALTHY \
                    and age > self.cfg.patience * self.cfg.beat_every:
                self._set(inst, SUSPECT, now)
                self.n_suspects += 1
        return newly_dead

    def heartbeat_age(self, iid: int, now: Optional[float] = None) -> float:
        """Time since the last beat seen from ``iid`` (diagnostics)."""
        now = self.last_observed if now is None else now
        return now - self.last_beat.get(iid, float("-inf"))

    def publish_metrics(self, registry, instances: Sequence = ()) -> None:
        """Publish detection counters (and, per instance, the observed
        health state + heartbeat age) into a ``repro_torch.obs`` registry.
        ``detector_health_state`` encodes healthy=0 / suspect=1 / dead=2
        so a dashboard can alert on any non-zero value."""
        registry.counter("detector_suspects_total",
                         "HEALTHY -> SUSPECT transitions") \
            .unlabeled.inc_to(self.n_suspects)
        registry.counter("detector_reinstated_total",
                         "false suspects reinstated by a fresh beat") \
            .unlabeled.inc_to(self.n_reinstated)
        registry.counter("detector_declared_dead_total",
                         "leases expired (final)") \
            .unlabeled.inc_to(self.n_declared_dead)
        registry.counter("detector_transitions_total",
                         "observed health transitions (append-only log)") \
            .unlabeled.inc_to(len(self.transitions))
        state_g = registry.gauge("detector_health_state",
                                 "observed health: healthy=0 suspect=1 "
                                 "dead=2", ("instance",))
        age_g = registry.gauge("detector_heartbeat_age_seconds",
                               "time since the last beat seen",
                               ("instance",))
        for inst in instances:
            state_g.labels(instance=inst.id).set(
                HEALTH_STATES.index(inst.health))
            age = self.heartbeat_age(inst.id)
            if age != float("inf"):
                age_g.labels(instance=inst.id).set(age)

    def next_deadline(self, instances: Sequence) -> float:
        """Earliest future time a detection state could change — the
        discrete-event backend folds this into its event horizon so a
        silent instance is eventually suspected/declared even when no
        other event would advance the clock. A hair past the threshold:
        ``observe`` transitions on *strictly* exceeded ages, so a wake at
        exactly ``last + patience`` would observe nothing and pin the
        horizon forever."""
        nxt = float("inf")
        for inst in instances:
            if inst.health == DEAD:
                continue
            last = self.last_beat.get(inst.id)
            if last is None:
                continue
            if inst.health == SUSPECT:
                nxt = min(nxt, last + self.cfg.lease)
            else:
                nxt = min(nxt, last + self.cfg.patience * self.cfg.beat_every)
        return nxt + 1e-6 if nxt != float("inf") else nxt


def execute_autoscale(scaler: GoodputAutoscaler, t: float,
                      instances: Sequence[InstanceBase],
                      spawn: Callable[[float], None],
                      events: List[Tuple[float, int]]) -> None:
    """Poll the scaler against the routable set and execute its decision:
    +1 spawns a fresh unified instance (via the backend's ``spawn``
    callback), -1 marks the least-loaded unified instance draining (no
    new routes; it retires once its in-flight work finishes). The scaler
    is told whether a drain victim exists, so a blocked action never
    commits cooldown state."""
    routable = [i for i in instances if not i.draining and i.alive]
    load = sum(i.kvc_allocated_frac() for i in routable) \
        / max(1, len(routable))
    n_drain = sum(1 for i in instances if i.draining and i.alive)
    victims = [i for i in routable if i.role == "unified"]
    action = scaler.decide(t, n_live=len(routable), n_draining=n_drain,
                           load_frac=load, can_drain=bool(victims))
    if action > 0:
        spawn(t)
        events.append((t, +1))
    elif action < 0:
        v = min(victims, key=lambda i: (i.outstanding_tokens(), -i.id))
        v.draining = True
        events.append((t, -1))
