"""Request routing policies for the cluster serving layer.

A router picks which instance serves a new request (and, for disaggregated
roles, which decode instance receives a migrated one). Candidates expose a
small stats protocol (``InstanceStats``) implemented by both backends — the
discrete-event ``ClusterSim`` instances and the real ``EngineFleet``
engines — so one policy implementation serves both.

Policies:

  * ``round-robin``    — cycle over the live candidates (by instance id, so
    the cycle is stable under instances joining/leaving).
  * ``least-tokens``   — fewest outstanding tokens (unprocessed prompt +
    predicted-remaining RL over queued and running requests): the classic
    least-outstanding-work balancer.
  * ``least-kvc``      — EconoServe-aware: score each instance by its
    *allocated*-KVC fraction (exact allocation means allocated, not used,
    is what bounds admission, §3.3) plus the fraction the request's
    predicted demand (prompt + padded predicted RL) would add; route to
    the minimum. This places a request where its KVC reservation is most
    likely to be granted immediately.

Ties are broken by a seeded RNG so multi-instance runs are reproducible:
two routers constructed with the same seed make identical choices on
identical inputs (``tests/test_cluster.py``).
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

import numpy as np

ROUTERS = ("round-robin", "least-tokens", "least-kvc")


class InstanceStats(Protocol):
    """What a router may observe about a candidate instance."""
    id: int

    def kvc_allocated_frac(self) -> float: ...
    def kvc_capacity_tokens(self) -> int: ...
    def outstanding_tokens(self) -> int: ...


class Router:
    """Base: seeded deterministic tie-breaking shared by all policies."""
    name = "base"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.n_decisions = 0
        self.n_tiebreaks = 0

    def choose(self, instances: Sequence[InstanceStats],
               demand_tokens: int) -> InstanceStats:
        """Pick one of ``instances`` (non-empty) for a request that is
        predicted to need ``demand_tokens`` of KVC. Counts the decision,
        then delegates to the policy's ``_choose``."""
        self.n_decisions += 1
        return self._choose(instances, demand_tokens)

    def _choose(self, instances: Sequence[InstanceStats],
                demand_tokens: int) -> InstanceStats:
        raise NotImplementedError

    def publish_metrics(self, registry, **labels) -> None:
        """Publish routing counters into a ``repro_torch.obs`` registry."""
        ln = ("policy",) + tuple(sorted(labels))
        registry.counter(
            "router_decisions_total", "routing decisions made",
            ln).labels(policy=self.name, **labels).inc_to(self.n_decisions)
        registry.counter(
            "router_tiebreaks_total", "decisions settled by the seeded "
            "rng", ln).labels(policy=self.name,
                              **labels).inc_to(self.n_tiebreaks)

    def _pick_min(self, instances: Sequence[InstanceStats],
                  scores: Sequence[float]) -> InstanceStats:
        best = min(scores)
        tied = [i for i, s in enumerate(scores) if s == best]
        if len(tied) == 1:
            return instances[tied[0]]
        self.n_tiebreaks += 1
        return instances[tied[int(self._rng.integers(len(tied)))]]


class RoundRobinRouter(Router):
    name = "round-robin"

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self._last: Optional[int] = None

    def _choose(self, instances, demand_tokens):
        ids = sorted(inst.id for inst in instances)
        if self._last is None:
            nxt = ids[0]
        else:
            after = [i for i in ids if i > self._last]
            nxt = after[0] if after else ids[0]
        self._last = nxt
        return next(inst for inst in instances if inst.id == nxt)


class LeastOutstandingTokensRouter(Router):
    name = "least-tokens"

    def _choose(self, instances, demand_tokens):
        return self._pick_min(
            instances, [float(inst.outstanding_tokens())
                        for inst in instances])


class LeastKVCRouter(Router):
    name = "least-kvc"

    def _choose(self, instances, demand_tokens):
        scores = []
        for inst in instances:
            cap = max(1, inst.kvc_capacity_tokens())
            scores.append(inst.kvc_allocated_frac()
                          + demand_tokens / cap)
        return self._pick_min(instances, scores)


def make_router(name: str, seed: int = 0) -> Router:
    try:
        cls = {"round-robin": RoundRobinRouter,
               "least-tokens": LeastOutstandingTokensRouter,
               "least-kvc": LeastKVCRouter}[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; one of {ROUTERS}")
    return cls(seed)
