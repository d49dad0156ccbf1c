"""KVC Pipelining (§3.2): lend the allocated-but-unused tail of a hosting
GT's exact allocation to hosted GTs, recursively (Russian nesting dolls).

Model: a GT with an allocation span of R tokens grows into it at one
token/iteration. Any sub-interval [o, o+s) of the span is free until the
owner's usage reaches o — i.e. for `o` iterations. The usable slots of a
span are its dyadic second halves:

    offset R/2,  size R/2   (deadline R/2 iterations)
    offset R/4,  size R/4   (deadline R/4)
    ...

A hosted GT with (padded) remaining RL r fits a slot iff r <= size - b,
where b is the safety buffer (O4 / §3.2). The hosted GT's own span then
recursively offers slots. If the owner reaches a slot boundary and the
hosted GT has not completed (RL under-prediction), the hosted GT is
preempted (copy-on-write to host memory, per the paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .request import Request


@dataclass
class Slot:
    owner: Request             # whose allocation the slot lives in
    offset: int                # tokens from the owner's span start
    size: int                  # tokens available
    child: Optional[Request] = None

    @property
    def deadline_age(self) -> int:
        """Owner run-age (iterations) at which the slot must be vacated."""
        return self.offset


def dyadic_slots(owner: Request, span: int, min_size: int) -> List[Slot]:
    """The owner's own-growth slots: second half, second quarter, ..."""
    slots = []
    s = span // 2
    while s >= min_size:
        slots.append(Slot(owner=owner, offset=s, size=s))
        s //= 2
    return slots


@dataclass
class PipeBook:
    """Tracks live host→hosted relations for the scheduler."""
    buffer_tokens: int
    min_size: int = 32
    open_slots: List[Slot] = field(default_factory=list)
    active: List[Slot] = field(default_factory=list)   # slots with a child

    def offer(self, owner: Request, span: int) -> None:
        """Register a newly scheduled GT's lendable slots."""
        self.open_slots.extend(dyadic_slots(owner, span, self.min_size))
        self.open_slots.sort(key=lambda s: -s.size)

    def _effective(self, s: Slot, age_of) -> int:
        """Usable tokens: the owner has already grown ``age`` tokens toward
        the slot boundary, and b tokens are kept as the safety buffer."""
        return s.size - age_of(s.owner) - self.buffer_tokens

    def max_hostable(self, age_of=lambda r: 0) -> int:
        if not self.open_slots:
            return 0
        return max(self._effective(s, age_of) for s in self.open_slots)

    def place(self, req: Request, need: int,
              age_of=lambda r: 0) -> Optional[Slot]:
        """Host `req` (remaining padded RL = need) in the best-fit slot."""
        best_i, best_eff = -1, None
        for i, s in enumerate(self.open_slots):
            eff = self._effective(s, age_of)
            if eff >= need and (best_eff is None or eff < best_eff):
                best_i, best_eff = i, eff
        if best_i < 0:
            return None
        slot = self.open_slots.pop(best_i)
        slot.child = req
        req.hosted = True
        self.active.append(slot)
        # the hosted span recursively offers its own slots
        self.open_slots.extend(dyadic_slots(req, need, self.min_size))
        self.open_slots.sort(key=lambda s: -s.size)
        return slot

    def expired(self, run_age_of) -> List[Slot]:
        """Slots whose owner reached the boundary with the child unfinished."""
        out = []
        for s in self.active:
            if s.child is not None and run_age_of(s.owner) >= s.deadline_age:
                out.append(s)
        return out

    def release_child(self, req: Request) -> None:
        """Child finished or was preempted — slot is NOT reusable (the owner
        is about to grow into it / other shares were sub-let)."""
        for s in self.active:
            if s.child is req:
                s.child = None
        self.active = [s for s in self.active if s.child is not None]
        req.hosted = False

    def drop_owner(self, req: Request) -> List[Request]:
        """Owner's allocation is being freed (completion with no children, or
        preemption): retract its open slots; children still running must be
        preempted by the caller if the memory really disappears."""
        self.open_slots = [s for s in self.open_slots if s.owner is not req]
        orphans = [s.child for s in self.active
                   if s.owner is req and s.child is not None]
        self.active = [s for s in self.active if s.owner is not req]
        return orphans
