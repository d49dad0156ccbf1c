"""Scheduler factory + one-call comparison harness."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from . import baselines, predictor, simulator, traces
from .costmodel import CostModel
from .metrics import SimResult
from .request import Request
from .scheduler import SchedulerConfig, make_econoserve

SCHEDULERS = ("orca", "srtf", "fastserve", "vllm", "sarathi", "multires",
              "synccoupled", "econoserve-d", "econoserve-sd",
              "econoserve-sdo", "econoserve", "oracle", "distserve")


def make_scheduler(name: str, cfg: SchedulerConfig, cost: CostModel):
    if name == "orca":
        return baselines.OrcaScheduler(cfg, cost)
    if name == "srtf":
        return baselines.SRTFScheduler(cfg, cost)
    if name == "fastserve":
        return baselines.FastServeScheduler(cfg, cost)
    if name == "vllm":
        return baselines.VLLMScheduler(cfg, cost)
    if name == "sarathi":
        return baselines.SarathiScheduler(cfg, cost)
    if name == "multires":
        return baselines.MultiResScheduler(cfg, cost)
    if name == "synccoupled":
        return baselines.SyncCoupledScheduler(cfg, cost)
    if name.startswith("econoserve"):
        variant = {"econoserve": "full", "econoserve-d": "d",
                   "econoserve-sd": "sd", "econoserve-sdo": "sdo"}[name]
        return make_econoserve(cfg, cost, variant)
    if name == "oracle":
        return make_econoserve(cfg, cost, "oracle")
    raise ValueError(name)


def needs_oracle_rl(name: str) -> bool:
    return name in ("oracle", "srtf")


def run_one(name: str, requests: Sequence[Request],
            cfg: Optional[SchedulerConfig] = None,
            cost: Optional[CostModel] = None,
            pad_ratio: float = 0.15, accuracy: float = 0.75,
            seed: int = 0, max_iters: int = 2_000_000) -> SimResult:
    """Clone requests, annotate predictions, simulate one scheduler."""
    import copy
    cfg = cfg or SchedulerConfig()
    cost = cost or CostModel()
    reqs = copy.deepcopy(list(requests))
    if needs_oracle_rl(name):
        pred = predictor.OraclePredictor(cfg.bucket)
        predictor.annotate(reqs, pred, 0.0, cfg.bucket)
    else:
        pred = predictor.NoisyPredictor(accuracy=accuracy, bucket=cfg.bucket,
                                        seed=seed)
        predictor.annotate(reqs, pred, pad_ratio, cfg.bucket)
    if name == "distserve":
        return baselines.simulate_distserve(reqs, cfg, cost,
                                            max_iters=max_iters)
    sched = make_scheduler(name, cfg, cost)
    return simulator.simulate(reqs, sched, cost, max_iters=max_iters)


def compare(names: Sequence[str], requests: Sequence[Request],
            cfg: Optional[SchedulerConfig] = None,
            cost: Optional[CostModel] = None,
            **kw) -> Dict[str, SimResult]:
    return {n: run_one(n, requests, cfg, cost, **kw) for n in names}


def run_cluster(name: str, requests: Sequence[Request],
                n_instances: int = 2, router: str = "least-kvc",
                roles: Optional[Sequence[str]] = None,
                cfg: Optional[SchedulerConfig] = None,
                cost: Optional[CostModel] = None,
                pad_ratio: float = 0.15, accuracy: float = 0.75,
                seed: int = 0, max_iters: int = 2_000_000,
                autoscaler=None):
    """Clone + annotate requests, then serve the stream across
    ``n_instances`` instances of scheduler ``name`` under a ClusterSim
    (optionally with disaggregated ``roles``, e.g. ("prefill", "decode")
    for a DistServe-style configuration). Each instance gets its own KVC
    of ``cfg.kvc_tokens`` — n instances model n GPUs."""
    import copy

    # imported lazily: repro_torch.cluster builds on repro_torch.core
    from repro_torch.cluster.sim import ClusterSim

    cfg = cfg or SchedulerConfig()
    cost = cost or CostModel()
    reqs = copy.deepcopy(list(requests))
    if needs_oracle_rl(name):
        pred = predictor.OraclePredictor(cfg.bucket)
        predictor.annotate(reqs, pred, 0.0, cfg.bucket)
    else:
        pred = predictor.NoisyPredictor(accuracy=accuracy, bucket=cfg.bucket,
                                        seed=seed)
        predictor.annotate(reqs, pred, pad_ratio, cfg.bucket)
    cs = ClusterSim(lambda i: make_scheduler(name, cfg, cost), cost,
                    n_instances=n_instances, router=router, roles=roles,
                    seed=seed, autoscaler=autoscaler)
    return cs.run(reqs, max_iters=max_iters)
