"""Cluster serving layer: one request stream across N engine instances.

Two interchangeable backends share routers, roles and the autoscaler:

  * ``ClusterSim``   — discrete-event simulation (N ``SimInstance``s under
    a shared event clock) for large-scale experiments (fig 12);
  * ``EngineFleet``  — N real in-process ``ServingEngine``s (shared model
    parameters, per-engine caches/schedulers) driven by one event loop,
    with live KV migration between disaggregated prefill/decode roles.

``repro_torch.cluster.faults`` adds the chaos layer both backends share:
scripted/probabilistic fault injection (kill / freeze / slow /
corrupt-KV / KVC squeeze / drop / dup / delay), bounded-retry crash
recovery with seeded backoff jitter, and the post-run conservation
audit (``check_fleet_invariants``). ``repro_torch.cluster.transport`` is the
lossy message layer those drop/dup/delay windows act on, and
``repro_torch.cluster.base`` hosts the heartbeat/lease ``FailureDetector``
that turns declared failure into *detected* failure on both backends.
``repro_torch.cluster.hedge`` adds straggler-aware hedged execution on top:
a progress watchdog races stalled (or suspect-hosted) requests on a
second instance under first-winner fencing — including across the
asymmetric network partitions (``part@t:a|b/dur``) the transport can
inject, where a partitioned instance keeps running as a zombie and its
late completions are counted, never double-delivered.
"""
from .autoscale import AutoscaleConfig, GoodputAutoscaler
from .base import (DEAD, DetectorConfig, FailureDetector, HEALTH_STATES,
                   HEALTHY, SUSPECT)
from .faults import (ChaosSpecError, FAULT_KINDS, FaultEvent, FaultInjector,
                     InvariantViolation, RecoveryConfig, backoff_delay,
                     check_fleet_invariants, parse_chaos_spec)
from .fleet import EngineFleet, FleetInstance
from .hedge import (HedgeConfig, HedgeCoordinator, HedgeViolation)
from .router import (LeastKVCRouter, LeastOutstandingTokensRouter, ROUTERS,
                     Router, RoundRobinRouter, make_router)
from .sim import ClusterInstance, ClusterResult, ClusterSim, ROLES
from .transport import DETECTOR, Message, Transport, Verdict
