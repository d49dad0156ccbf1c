"""Deterministic chaos layer for the cluster backends.

``FaultInjector`` fires scripted (or seeded-probabilistic) instance
faults — crash, freeze, straggler slowdown, live KVC capacity squeeze —
and corrupts KV-migration payloads in flight.  Both backends poll it
from their event loops:
``EngineFleet`` (real engines) and ``ClusterSim`` (discrete-event model)
share the same injector, so a fault schedule reproduces bit-for-bit on
either.

``RecoveryConfig`` bounds what the fleet does about it: per-request
retry budget with exponential backoff, a hard deadline multiple past
which requests are aborted, and admission shedding when projected
completion would blow the SLO anyway.

``check_fleet_invariants`` is the conservation audit run after every
chaos battery: every submitted request reaches exactly one terminal
state (completed | aborted | shed), and no live engine leaks KVC
blocks, batch slots, or ring/drain state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .base import DEAD, HEALTHY, SUSPECT

FAULT_KINDS = ("kill", "freeze", "slow", "corrupt_kv", "squeeze",
               "drop", "dup", "delay", "part")

#: kinds that perturb the message transport, not an instance's health
TRANSPORT_KINDS = ("drop", "dup", "delay", "part")

#: kinds that set (or, detected, eventually cause) a health transition —
#: two different ones on the same instance at the same tick contradict
HEALTH_KINDS = ("kill", "freeze", "slow")


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One scripted fault. ``target`` is an instance id (-1 = injector
    picks among the alive; for transport kinds, every link);
    ``duration``/``factor`` only apply to freeze/slow (for transport
    kinds ``duration`` is the fault-window length); ``count`` only to
    corrupt_kv (number of payloads); ``frac`` only to squeeze (fraction
    of KVC capacity removed) and drop/dup (per-message probability);
    ``delay`` only to the delay kind (added latency); ``peer`` only to
    ``part`` (the instance standing in for the majority side of the
    cut — ``target`` is the partitioned-away minority)."""
    t: float
    kind: str = "kill"
    target: int = -1
    duration: float = 8.0
    factor: int = 2
    count: int = 1
    frac: float = 0.5
    delay: float = 2.0
    peer: int = -1

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind
        if self.kind in ("squeeze", "drop", "dup"):
            assert 0.0 < self.frac <= 1.0, self.frac
        if self.kind == "part":
            assert self.target >= 0 and self.peer >= 0, \
                "part needs explicit a|b instance ids"
            assert self.target != self.peer, "self-partition"
            assert self.duration > 0, self.duration


@dataclass
class RecoveryConfig:
    """Fleet-side policy for surviving injected (or real) faults.

    ``jitter`` spreads redelivery backoff to avoid synchronized retry
    herds after a mass reclaim: each delay is stretched by up to
    ``jitter`` (fractionally), keyed on a CRC of (rid, attempt,
    ``jitter_seed``) — fully deterministic under a fixed seed, and the
    default ``jitter=0.0`` reproduces the legacy schedule bit-for-bit."""
    max_retries: int = 3          # recovery attempts per request
    backoff_base: float = 2.0     # redelivery delay = base * 2**attempt
    deadline_factor: float = 0.0  # abort past submit + k*(deadline-submit);
                                  # 0 disables the watchdog
    shed: bool = False            # reject admissions projected to miss SLO
    shed_headroom: float = 1.0    # safety multiplier on the projection
    jitter: float = 0.0           # max fractional backoff stretch
    jitter_seed: int = 0          # decorrelates fleets sharing a schedule
    shed_retry: bool = False      # fleet-level second chance for rung-4
                                  # kvc-infeasible sheds: re-route to a
                                  # peer whose total KVC can fund the
                                  # frozen demand (bounded by max_retries);
                                  # terminal shed only when no live peer
                                  # can ever fit the request


def backoff_delay(rc: RecoveryConfig, rid: int, attempt: int) -> float:
    """Exponential backoff with deterministic seeded jitter (shared by
    both backends so a recovery schedule reproduces bit-for-bit)."""
    import zlib
    delay = rc.backoff_base * (2.0 ** attempt)
    if rc.jitter:
        h = zlib.crc32(f"{rid}:{attempt}:{rc.jitter_seed}".encode())
        delay *= 1.0 + rc.jitter * (h / 0xFFFFFFFF)
    return delay


class InvariantViolation(AssertionError):
    """A conservation / leak invariant failed after a chaos run."""


class FaultInjector:
    """Schedule-driven + seeded-probabilistic fault source.

    ``poll(t, instances)`` fires every scheduled event with ``ev.t <= t``
    and then rolls per-alive-instance probabilistic faults; it returns
    the list of events fired this call (empty most of the time).
    ``corrupt_payload`` is called by the migration path on every KV
    payload and flips one tensor element when a corruption is pending.

    Scheduled kills always fire; probabilistic kills never reduce the
    fleet below ``min_alive``.

    **Declared vs detected.** By default the injector *declares* health
    (kill writes ``DEAD``, freeze/slow write ``SUSPECT``) — the legacy
    oracle mode. When a backend attaches a failure detector it flips
    ``detected`` on and binds ``transport``: a kill then only sets
    ``crashed`` (the instance falls silent) and a freeze only sets
    ``frozen_until`` — the *observed* health is owned by the detector,
    which must notice the missing heartbeats. Transport kinds
    (drop/dup/delay) open fault windows on the bound transport and
    require one.
    """

    def __init__(self, schedule: Sequence[FaultEvent] = (),
                 p_kill: float = 0.0, p_freeze: float = 0.0,
                 p_corrupt: float = 0.0, freeze_duration: float = 8.0,
                 seed: int = 0, min_alive: int = 1):
        self.schedule = sorted(schedule)
        self._idx = 0
        self.p_kill = p_kill
        self.p_freeze = p_freeze
        self.p_corrupt = p_corrupt
        self.freeze_duration = freeze_duration
        self.min_alive = min_alive
        self.rng = np.random.default_rng(seed)
        self._pending_corrupt = 0     # payloads left to corrupt
        self.n_corrupted = 0
        self.detected = False         # failure-detector mode (see class doc)
        self.transport = None         # bound by the backend (drop/dup/delay)
        self.log: List[Tuple[float, str, int]] = []

    # ------------------------------------------------------------------ #
    def poll(self, t: float, instances: Sequence) -> List[FaultEvent]:
        fired: List[FaultEvent] = []
        while self._idx < len(self.schedule) and self.schedule[self._idx].t <= t:
            ev = self.schedule[self._idx]
            self._idx += 1
            if self._apply(ev, t, instances, forced=True):
                fired.append(ev)
        if self.p_kill or self.p_freeze or self.p_corrupt:
            for inst in instances:
                if not inst.alive:
                    continue
                if self.p_kill and self.rng.random() < self.p_kill:
                    ev = FaultEvent(t=t, kind="kill", target=inst.id)
                    if self._apply(ev, t, instances, forced=False):
                        fired.append(ev)
                elif self.p_freeze and self.rng.random() < self.p_freeze:
                    ev = FaultEvent(t=t, kind="freeze", target=inst.id,
                                    duration=self.freeze_duration)
                    if self._apply(ev, t, instances, forced=False):
                        fired.append(ev)
            if self.p_corrupt and self.rng.random() < self.p_corrupt:
                self._pending_corrupt += 1
                self.log.append((t, "corrupt_kv", -1))
        return fired

    def _apply(self, ev: FaultEvent, t: float, instances: Sequence,
               forced: bool) -> bool:
        if ev.kind == "corrupt_kv":
            self._pending_corrupt += ev.count
            self.log.append((t, ev.kind, ev.target))
            return True
        if ev.kind in TRANSPORT_KINDS:
            assert self.transport is not None, \
                f"{ev.kind} fault needs a transport-backed fleet " \
                f"(detector mode) — plain fleets have no message layer"
            self.transport.add_fault(ev)
            self.log.append((t, ev.kind, ev.target))
            return True
        inst = self._resolve(ev.target, instances)
        if inst is None:
            return False
        if ev.kind == "kill":
            alive = sum(1 for i in instances
                        if i.alive and not getattr(i, "crashed", False))
            if not forced and alive <= self.min_alive:
                return False            # probabilistic kills spare the last
            if self.detected:
                inst.crashed = True     # falls silent; detection follows
            else:
                inst.health = DEAD
        elif ev.kind == "freeze":
            if not self.detected:
                inst.health = SUSPECT
            inst.frozen_until = max(inst.frozen_until, t + ev.duration)
        elif ev.kind == "slow":
            if not self.detected:
                inst.health = SUSPECT
            inst.slow_until = max(inst.slow_until, t + ev.duration)
            inst.slow_factor = max(2, int(ev.factor))
        elif ev.kind == "squeeze":
            # live capacity reduction: the instance sheds `frac` of its
            # KVC (free blocks immediately, held blocks as they free) and
            # must degrade through the ladder, not crash on allocation
            inst.squeeze_kvc(ev.frac)
        self.log.append((t, ev.kind, inst.id))
        return True

    def _resolve(self, target: int, instances: Sequence):
        if target >= 0:
            for i in instances:
                if i.id == target:
                    return i if i.alive and not getattr(i, "crashed", False) \
                        else None
            return None
        cands = [i for i in instances if i.health == HEALTHY
                 and not getattr(i, "crashed", False)]
        if not cands:
            return None
        return cands[int(self.rng.integers(len(cands)))]

    # ------------------------------------------------------------------ #
    def corrupt_payload(self, payload: dict) -> dict:
        """Bit-flip one element of the first KV tensor when a corruption
        is pending. The checksum in the payload is left as exported, so
        the receiver's verify step rejects it."""
        if self._pending_corrupt <= 0 or payload.get("kv") is None:
            return payload
        self._pending_corrupt -= 1
        self.n_corrupted += 1
        # the image holds tensors (bf16 has no numpy dtype): clone each
        # leaf and add 1 to element 0 of the first kind's ``k``
        kv = {kind: {n: a.clone() for n, a in kv_part.items()}
              for kind, kv_part in payload["kv"].items()}
        kind = sorted(kv)[0]
        arr = kv[kind]["k"]
        arr[(0,) * arr.dim()] += 1
        out = dict(payload)
        out["kv"] = kv
        return out


# ---------------------------------------------------------------------- #
# chaos spec parsing — "kill@25:1,freeze@40:2/20,slow@10:-1/30x3"
# ---------------------------------------------------------------------- #
class ChaosSpecError(ValueError):
    """A malformed ``--chaos`` clause, named precisely. A typo in a chaos
    schedule must fail loudly at parse time — not half-parse into a no-op
    (or wrong-target) fault that silently weakens the chaos run."""


def _chaos_num(text: str, what: str, clause: str, conv):
    try:
        return conv(text)
    except ValueError:
        raise ChaosSpecError(
            f"bad {what} {text!r} in chaos clause {clause!r}") from None


def parse_chaos_spec(spec: str,
                     n_instances: Optional[int] = None) -> List[FaultEvent]:
    """Parse ``kind@t[:target][/duration][xfactor]`` items, comma-separated.

    Examples::

        kill@25            kill some healthy instance at t=25
        kill@25:1          kill instance 1 at t=25
        freeze@40:2/20     freeze instance 2 for 20s at t=40
        slow@10:0/30x3     slow instance 0 by 3x for 30s at t=10
        corrupt@15         corrupt the next KV migration after t=15
        squeeze@30:1/0.5   drop half of instance 1's KVC capacity at t=30
        drop@10:1/0.6      drop messages on instance 1's link w.p. 0.6
        dup@12:2/0.5       duplicate messages on instance 2's link w.p. 0.5
        delay@8:0/2.5      delay instance 0's messages by 2.5
        part@6:2|0/12      partition instance 2 from instance 0's side
                           (and the control plane) for 12 time units

    For ``squeeze`` and the transport kinds drop/dup/delay the ``/``
    clause is *not* a duration: it is the capacity fraction removed
    (squeeze, permanent), the per-message probability (drop/dup), or
    the added latency (delay). For ``part`` it *is* the partition
    duration (required positive). Transport fault windows last the
    ``FaultEvent.duration`` default (8 time units) from their fire time
    and need a detector/transport-backed fleet. Malformed input raises
    :class:`ChaosSpecError` naming the offending clause and field:
    unknown kinds, a ``part`` self-partition (``a|a``), a non-positive
    partition duration, a target outside ``range(n_instances)`` (when
    the caller passes the fleet size), and two contradictory health
    faults (kill/freeze/slow) aimed at the same instance at the same
    tick — injector order must not decide which one silently wins.
    """
    events: List[FaultEvent] = []
    clauses: List[str] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        raw_kind, sep, rest = item.partition("@")
        if not sep or not rest:
            raise ChaosSpecError(
                f"chaos clause {item!r} is not of the form "
                f"'kind@t[:target][/duration][xfactor]'")
        kind = {"corrupt": "corrupt_kv"}.get(raw_kind, raw_kind)
        if kind not in FAULT_KINDS:
            raise ChaosSpecError(
                f"unknown fault kind {raw_kind!r} in chaos clause "
                f"{item!r} (valid: kill, freeze, slow, corrupt, squeeze, "
                f"drop, dup, delay, part)")
        factor = 2
        if "x" in rest and kind != "part":
            rest, _, f = rest.rpartition("x")
            factor = _chaos_num(f, "slowdown factor", item, int)
        duration, frac, delay = 8.0, 0.5, 2.0
        if "/" in rest:
            rest, _, d = rest.partition("/")
            if kind == "squeeze" or kind in ("drop", "dup"):
                what = "capacity fraction" if kind == "squeeze" \
                    else "message probability"
                frac = _chaos_num(d, what, item, float)
                if not 0.0 < frac <= 1.0:
                    raise ChaosSpecError(
                        f"{what} {frac} outside (0, 1] in "
                        f"chaos clause {item!r}")
            elif kind == "delay":
                delay = _chaos_num(d, "delay", item, float)
                if delay <= 0:
                    raise ChaosSpecError(
                        f"delay {delay} must be positive in "
                        f"chaos clause {item!r}")
            else:
                duration = _chaos_num(d, "duration", item, float)
                if kind == "part" and duration <= 0:
                    raise ChaosSpecError(
                        f"partition duration {duration:g} must be "
                        f"positive in chaos clause {item!r}")
        target, peer = -1, -1
        if ":" in rest:
            rest, _, tg = rest.partition(":")
            if kind == "part":
                a_txt, bar, b_txt = tg.partition("|")
                if not bar:
                    raise ChaosSpecError(
                        f"part clause {item!r} needs an 'a|b' target "
                        f"(partitioned instance | majority-side peer)")
                target = _chaos_num(a_txt, "partitioned instance", item,
                                    int)
                peer = _chaos_num(b_txt, "partition peer", item, int)
                if target == peer:
                    raise ChaosSpecError(
                        f"self-partition {target}|{peer} in chaos "
                        f"clause {item!r}: an instance cannot be cut "
                        f"off from itself")
            else:
                target = _chaos_num(tg, "target instance", item, int)
        elif kind == "part":
            raise ChaosSpecError(
                f"part clause {item!r} needs an ':a|b' target "
                f"(partitioned instance | majority-side peer)")
        if kind == "part" and n_instances is not None:
            for label, iid in (("partitioned instance", target),
                               ("partition peer", peer)):
                if not 0 <= iid < n_instances:
                    raise ChaosSpecError(
                        f"unknown instance {iid} as {label} in chaos "
                        f"clause {item!r} (fleet has instances "
                        f"0..{n_instances - 1})")
        t = _chaos_num(rest, "fire time", item, float)
        events.append(FaultEvent(t=t, kind=kind, target=target,
                                 duration=duration, factor=factor,
                                 frac=frac, delay=delay, peer=peer))
        clauses.append(item)
    # contradictory health faults on the same instance at the same tick:
    # applying them in injector order would silently pick a winner
    seen: dict = {}
    for ev, clause in zip(events, clauses):
        if ev.kind not in HEALTH_KINDS or ev.target < 0:
            continue
        key = (ev.t, ev.target)
        prev = seen.get(key)
        if prev is not None and prev[0].kind != ev.kind:
            raise ChaosSpecError(
                f"contradictory chaos clauses {prev[1]!r} and {clause!r}: "
                f"both target instance {ev.target} at t={ev.t:g} with "
                f"conflicting health faults "
                f"({prev[0].kind} vs {ev.kind})")
        seen[key] = (ev, clause)
    return events


# ---------------------------------------------------------------------- #
# conservation / leak audit
# ---------------------------------------------------------------------- #
def check_fleet_invariants(fleet, strict: bool = True) -> dict:
    """Audit an ``EngineFleet`` after it drained: exactly-once terminal
    states over everything submitted, zero resource leaks on every live
    engine, and — with at-least-once delivery in play — no ghost
    registrations (one request live on two engines at once) and no
    duplicate terminal transitions (a second completion writer is
    suppressed first-writer-wins and *counted*; any non-zero count means
    the delivery-dedup boundary leaked a duplicate through). Returns a
    report dict; raises ``InvariantViolation`` listing every failure
    when ``strict``."""
    problems: List[str] = []
    n_completed = n_aborted = n_shed = 0
    for g in fleet.submitted:
        status = getattr(g, "status", None)
        if status == "completed" or (status is None and g.t_done is not None):
            n_completed += 1
        elif status == "aborted":
            n_aborted += 1
        elif status == "shed":
            n_shed += 1
        else:
            problems.append(f"request non-terminal: status={status!r} "
                            f"t_done={g.t_done} prompt_len={len(g.prompt)}")
    if fleet.double_routes:
        problems.append(f"double routes: {fleet.double_routes}")
    if getattr(fleet, "_redeliver", None):
        problems.append(f"undelivered recoveries: {len(fleet._redeliver)}")
    transport = getattr(fleet, "transport", None)
    if transport is not None and transport.pending():
        problems.append(
            f"undelivered transport messages: {transport.pending()}")
    # ghost/duplicate registration: the same GenRequest live under two
    # engines means a duplicated delivery was accepted twice
    owners: dict = {}
    for inst in fleet.instances:
        if inst.crashed or (not inst.alive and not inst.detected):
            continue    # device state lost; zombies stay auditable
        for rid, g in inst.engine.requests.items():
            owners.setdefault(id(g), []).append(f"i{inst.id}:rid{rid}")
    n_ghosts = 0
    for tags in owners.values():
        if len(tags) > 1:
            n_ghosts += 1
            problems.append(f"ghost registration: one request live on "
                            f"{tags}")
    n_dup_completions = sum(getattr(i.engine, "n_dup_completions", 0)
                            for i in fleet.instances)
    if n_dup_completions:
        problems.append(f"duplicate terminal transitions suppressed "
                        f"first-writer-wins: {n_dup_completions} "
                        f"(delivery dedup leaked a duplicate)")
    for inst in fleet.instances:
        if inst.crashed or (not inst.alive and not inst.detected):
            continue    # crashed (or oracle-declared dead): state is by
                        # definition lost. A *detected* DEAD instance
                        # that never crashed is a zombie — it kept
                        # stepping through its partition and must hold
                        # zero leaked resources after the heal.
        eng = inst.engine
        tag = f"instance {inst.id}"
        if eng.has_work():
            problems.append(f"{tag}: engine still has work")
        try:
            eng.scheduler.kvc.check_invariants()
        except AssertionError as e:
            problems.append(f"{tag}: KVC invariant: {e}")
        if eng.scheduler.kvc.allocs:
            problems.append(f"{tag}: leaked KVC allocs "
                            f"{sorted(eng.scheduler.kvc.allocs)}")
        if eng.scheduler.kvc.swapped:
            problems.append(f"{tag}: leaked swap-ledger entries "
                            f"{sorted(eng.scheduler.kvc.swapped)}")
        if getattr(eng.scheduler, "swap_hold", None):
            problems.append(f"{tag}: leaked swap holds "
                            f"{sorted(eng.scheduler.swap_hold)}")
        if len(eng.free_slots) != eng.max_batch:
            problems.append(f"{tag}: slot leak {len(eng.free_slots)}/"
                            f"{eng.max_batch}")
        if eng.slot_of:
            problems.append(f"{tag}: slot_of not empty {sorted(eng.slot_of)}")
        for name in ("_pending_drain", "_chunk_progress", "_rec_state",
                     "_arrivals", "_pending_injects", "_pending_aborts",
                     "_host_swap", "shed_handback"):
            v = getattr(eng, name, None)
            if v:
                problems.append(f"{tag}: {name} not empty ({len(v)})")
    report = {
        "completed": n_completed, "aborted": n_aborted, "shed": n_shed,
        "submitted": len(fleet.submitted),
        "ghost_registrations": n_ghosts,
        "dup_completions": n_dup_completions,
        "dup_deliveries": sum(getattr(i.engine, "n_dup_deliveries", 0)
                              for i in fleet.instances),
        "problems": problems,
        "ok": not problems,
    }
    if strict and problems:
        raise InvariantViolation("; ".join(problems))
    return report
