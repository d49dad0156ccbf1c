"""Unreliable message transport between the fleet/router and instances.

Every control-plane message — heartbeats, routed submissions, KV-inject
payloads — travels through a per-destination delivery queue keyed on
delivery time. Scripted fault windows (the ``drop``/``dup``/``delay``
chaos kinds) perturb each send with a seeded rng:

  * ``drop``  — the message is lost on the wire. Data-plane messages are
    *retransmitted* after ``retransmit_after`` (at-least-once delivery:
    the sender keeps the message until acknowledged; we model the retry
    timer, not the ACK round-trip). Heartbeats are fire-and-forget — a
    dropped beat is simply missing, which is what drives the failure
    detector's false suspects.
  * ``dup``   — the message is delivered twice (retransmit racing a slow
    ACK). Both copies carry the same delivery key (``dkey``), so the
    receiver's idempotency table suppresses the second.
  * ``delay`` — delivery is deferred by the window's delay; messages
    sent later through a clean link can overtake it (reordering falls
    out of the queue ordering, it is not a separate fault).
  * ``part``  — a network partition: instance ``a`` is cut off from the
    side holding instance ``b`` **and the fleet control plane** (the
    router/detector hub all control traffic transits). The two sides
    are asymmetric — a minority of one against the rest of the fleet —
    and so are the two directions: ``a``'s outbound heartbeats are
    fire-and-forget and simply *lost* (which is what drives the
    detector to suspect and eventually declare it dead, while the
    instance itself keeps stepping as a zombie), whereas data-plane
    messages crossing the cut in either direction are *held* by the
    sender's retry timer and land just after the heal (at-least-once
    delivery: the sender keeps retrying into the void until the link
    returns). A cancel sent to fence a zombie therefore reconciles it
    at heal time; the zombie's own late completions must be fenced by
    the receiving side, never double-delivered.

With no active window the transport draws **zero** rng samples and
delivers same-tick in FIFO order — a no-fault run is bitwise-identical
to calling the receiver directly. ``ClusterSim`` owns its own delivery
queues (the routed-``pending`` lists and the migration heap) and only
asks the transport to *judge* each send (``judge``), so one chaos
schedule reproduces on either backend.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# message kinds
BEAT = "beat"
SUBMIT = "submit"
INJECT = "inject"
CANCEL = "cancel"       # fence a re-routed request on its old host

#: destination address of the failure detector (heartbeat sink)
DETECTOR = -1

_INF = float("inf")


@dataclass
class Message:
    """One transport message. ``send_t`` is the sender's clock at send
    time (receivers that need the original timestamp — e.g. a submit's
    arrival time — read it from here, not from the delivery clock).
    ``dkey`` identifies the *logical* delivery for receiver-side
    idempotency: duplicated copies share it, retries get a fresh one."""
    dst: int
    kind: str
    payload: object
    send_t: float
    seq: int
    dkey: Optional[tuple] = None


@dataclass(frozen=True)
class Verdict:
    """What the fault windows decided about one send (``judge``).
    ``heal > 0`` means the link is partitioned: the message is held by
    the sender's retry timer and can land no earlier than ``heal``."""
    drop: bool = False
    dup: bool = False
    delay: float = 0.0
    heal: float = 0.0


@dataclass
class _Window:
    """One active transport-fault window on an instance's link.
    ``target == -1`` faults every link."""
    kind: str                 # drop | dup | delay
    target: int
    t0: float
    t1: float
    frac: float = 0.5         # per-message probability (drop/dup)
    delay: float = 2.0        # added latency (delay)

    def active(self, link: int, now: float) -> bool:
        return (self.t0 <= now < self.t1
                and (self.target < 0 or self.target == link))


@dataclass
class _Partition:
    """One partition window: instance ``a`` severed from the side that
    holds instance ``b`` and the control plane. Only ``a``'s link is
    cut — ``b`` stands in for the majority side, whose own links stay
    clean."""
    a: int
    b: int
    t0: float
    t1: float

    def covers(self, link: int, now: float) -> bool:
        return self.t0 <= now < self.t1 and link == self.a


class Transport:
    """Seeded lossy message layer. ``send``/``recv`` give the real-engine
    fleet an actual in-flight queue; ``judge`` lets the discrete-event
    sim apply identical fault decisions to its own delivery structures.
    """

    def __init__(self, seed: int = 0, retransmit_after: float = 4.0):
        self.rng = np.random.default_rng(seed)
        self.retransmit_after = retransmit_after
        self.windows: List[_Window] = []
        self.partitions: List[_Partition] = []
        self._q: Dict[int, List[Tuple[float, int, Message]]] = {}
        self._seq = 0
        self.n_dropped = 0
        self.n_duplicated = 0
        self.n_delayed = 0
        self.n_retransmits = 0
        self.n_partition_lost = 0      # beats swallowed by a partition
        self.n_partition_held = 0      # data-plane sends held until heal

    # -- fault windows -------------------------------------------------- #
    def add_fault(self, ev) -> None:
        """Open a fault window from a ``FaultEvent``. Transport kinds
        drop/dup/delay open a ``_Window`` on instance ``ev.target``'s
        link for ``[ev.t, ev.t + ev.duration)``; kind ``part`` opens a
        ``_Partition`` cutting ``ev.target`` off from the side holding
        ``ev.peer`` and the control plane."""
        if ev.kind == "part":
            assert ev.peer >= 0 and ev.peer != ev.target, (ev.target,
                                                           ev.peer)
            self.partitions.append(_Partition(
                a=ev.target, b=ev.peer, t0=ev.t, t1=ev.t + ev.duration))
            return
        assert ev.kind in ("drop", "dup", "delay"), ev.kind
        self.windows.append(_Window(
            kind=ev.kind, target=ev.target, t0=ev.t, t1=ev.t + ev.duration,
            frac=ev.frac, delay=ev.delay))

    def partition_heal(self, link: int, now: float) -> float:
        """Heal time of the latest active partition covering ``link``'s
        side, or 0.0 when the link is clean."""
        heal = 0.0
        for p in self.partitions:
            if p.covers(link, now):
                heal = max(heal, p.t1)
        return heal

    def partitioned(self, link: int, now: float) -> bool:
        return self.partition_heal(link, now) > 0.0

    def _roll(self, kind: str, link: int, now: float) -> Optional[_Window]:
        """The first active window of ``kind`` on ``link`` whose seeded
        coin lands, or None. No active window => no rng draw at all."""
        for w in self.windows:
            if w.kind == kind and w.active(link, now):
                if kind == "delay" or self.rng.random() < w.frac:
                    return w
                return None
        return None

    def judge(self, link: int, now: float) -> Verdict:
        """Fault decision for one send on ``link`` (sim data plane)."""
        if self.partitions:
            heal = self.partition_heal(link, now)
            if heal > 0.0:
                self.n_partition_held += 1
                return Verdict(heal=heal)
        if not self.windows:
            return Verdict()
        w_delay = self._roll("delay", link, now)
        delay = w_delay.delay if w_delay is not None else 0.0
        if delay:
            self.n_delayed += 1
        if self._roll("drop", link, now) is not None:
            self.n_dropped += 1
            return Verdict(drop=True, delay=delay)
        dup = self._roll("dup", link, now) is not None
        if dup:
            self.n_duplicated += 1
        return Verdict(dup=dup, delay=delay)

    # -- data plane (EngineFleet) --------------------------------------- #
    def _push(self, deliver_t: float, msg: Message) -> None:
        self._seq += 1
        heapq.heappush(self._q.setdefault(msg.dst, []),
                       (deliver_t, self._seq, msg))

    def send(self, dst: int, kind: str, payload, now: float,
             dkey: Optional[tuple] = None, link: Optional[int] = None
             ) -> None:
        """Send one message. ``link`` is the instance whose network link
        the fault windows match (defaults to ``dst``; heartbeats pass the
        *source* instance — the detector's address is not a link)."""
        self._seq += 1
        msg = Message(dst=dst, kind=kind, payload=payload, send_t=now,
                      seq=self._seq, dkey=dkey)
        link = dst if link is None else link
        if self.partitions:
            heal = self.partition_heal(link, now)
            if heal > 0.0:
                if kind == BEAT:
                    # fire-and-forget liveness: lost into the cut — the
                    # detector's missed-beat walk is the whole point
                    self.n_partition_lost += 1
                else:
                    # at-least-once: the sender's retry timer keeps the
                    # message alive and it lands just after the heal
                    self.n_partition_held += 1
                    self._push(max(now + self.retransmit_after, heal), msg)
                return
        v = self.judge(link, now)
        if v.drop:
            if kind != BEAT:
                # at-least-once: the sender's retry timer re-delivers
                self.n_retransmits += 1
                self._push(now + v.delay + self.retransmit_after, msg)
            return
        self._push(now + v.delay, msg)
        if v.dup:
            self._push(now + v.delay, msg)     # same dkey: receiver dedups

    def recv(self, dst: int, now: float) -> List[Message]:
        """Pop every message to ``dst`` whose delivery time has come,
        in (delivery time, send order)."""
        q = self._q.get(dst)
        if not q:
            return []
        out: List[Message] = []
        while q and q[0][0] <= now:
            out.append(heapq.heappop(q)[2])
        return out

    # -- introspection -------------------------------------------------- #
    def pending(self) -> int:
        """In-flight *data-plane* messages (beats excluded — they are
        periodic and carry no work)."""
        return sum(len(q) for dst, q in self._q.items() if dst != DETECTOR)

    def next_time(self) -> float:
        """Earliest pending data-plane delivery time (inf when idle)."""
        t = _INF
        for dst, q in self._q.items():
            if dst != DETECTOR and q:
                t = min(t, q[0][0])
        return t
