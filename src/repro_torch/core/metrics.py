"""Simulation metrics: everything the paper's figures report."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .request import Request


@dataclass
class IterSample:
    t: float
    dt: float
    forward_size: int
    prompt_tokens: int
    n_decode: int
    kvc_used_frac: float
    kvc_alloc_frac: float
    sched_time: float
    extra_time: float
    n_completed: int


@dataclass
class SimResult:
    name: str
    requests: List[Request]
    samples: List[IterSample]
    wall_time: float
    tfs: int
    n_alloc_failures: int = 0
    n_allocs: int = 0
    n_preempt_swap: int = 0
    n_preempt_free: int = 0
    n_underprov: int = 0
    n_reserve_rescues: int = 0

    # ------------------------------------------------------------------ #
    @property
    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.t_complete is not None]

    @property
    def throughput_tokens(self) -> float:
        toks = sum(r.true_rl + r.prompt_len for r in self.completed)
        return toks / max(1e-9, self.wall_time)

    @property
    def throughput_reqs(self) -> float:
        return len(self.completed) / max(1e-9, self.wall_time)

    @property
    def goodput(self) -> float:
        """Requests per second that met their SLO (fig 12)."""
        return sum(r.met_slo for r in self.completed) / max(1e-9, self.wall_time)

    @property
    def mean_jct(self) -> float:
        c = self.completed
        return float(np.mean([r.jct for r in c])) if c else float("nan")

    @property
    def p95_jct(self) -> float:
        c = self.completed
        return float(np.percentile([r.jct for r in c], 95)) if c else float("nan")

    @property
    def normalized_latency(self) -> float:
        """Mean end-to-end latency / output length (fig 9, per vLLM defn)."""
        c = self.completed
        if not c:
            return float("nan")
        return float(np.mean([r.jct / max(1, r.true_rl) for r in c]))

    @property
    def ssr(self) -> float:
        c = self.completed
        return sum(r.met_slo for r in c) / max(1, len(c))

    @property
    def mean_tbt(self) -> float:
        """Time between tokens ≈ (completion - first token)/RL."""
        c = [r for r in self.completed if r.t_first_token is not None
             and r.true_rl > 1]
        if not c:
            return float("nan")
        return float(np.mean([(r.t_complete - r.t_first_token)
                              / max(1, r.true_rl - 1) for r in c]))

    # ---- time-weighted utilizations ------------------------------------ #
    def _tw(self, vals, dts) -> float:
        dts = np.asarray(dts)
        if dts.sum() <= 0:
            return float("nan")
        return float(np.average(np.asarray(vals), weights=dts))

    @property
    def kvc_utilization(self) -> float:
        return self._tw([s.kvc_used_frac for s in self.samples],
                        [s.dt for s in self.samples])

    @property
    def kvc_allocated(self) -> float:
        return self._tw([s.kvc_alloc_frac for s in self.samples],
                        [s.dt for s in self.samples])

    @property
    def gpu_utilization(self) -> float:
        """Forward-size / TFS, time-weighted (the paper's proxy)."""
        return self._tw([min(1.0, s.forward_size / max(1, self.tfs))
                         for s in self.samples],
                        [s.dt for s in self.samples])

    @property
    def mean_forward_size(self) -> float:
        return self._tw([s.forward_size for s in self.samples],
                        [s.dt for s in self.samples])

    @property
    def alloc_failure_rate(self) -> float:
        tot = self.n_allocs + self.n_alloc_failures
        return self.n_alloc_failures / max(1, tot)

    @property
    def sched_overhead_frac(self) -> float:
        tot = sum(s.dt + s.sched_time + s.extra_time for s in self.samples)
        sch = sum(s.sched_time for s in self.samples)
        return sch / max(1e-9, tot)

    # ---- JCT decomposition (fig 1e) ------------------------------------ #
    def jct_breakdown(self) -> Dict[str, float]:
        c = self.completed
        if not c:
            return {}
        return {
            "waiting": float(np.mean([r.waiting_time for r in c])),
            "gt_queue": float(np.mean([r.gt_queue_time for r in c])),
            "exec": float(np.mean([r.exec_time for r in c])),
            "preempt": float(np.mean([r.preempt_time for r in c])),
            "sched": float(np.mean([r.sched_time for r in c])),
        }

    def completion_count_dist(self) -> Dict[int, int]:
        """Iterations by number of requests completed (fig 1f)."""
        out: Dict[int, int] = {}
        for s in self.samples:
            out[s.n_completed] = out.get(s.n_completed, 0) + 1
        return out

    def summary(self) -> Dict[str, float]:
        return {
            "throughput_tok_s": self.throughput_tokens,
            "throughput_req_s": self.throughput_reqs,
            "goodput_req_s": self.goodput,
            "mean_jct_s": self.mean_jct,
            "p95_jct_s": self.p95_jct,
            "norm_latency_s_per_tok": self.normalized_latency,
            "ssr": self.ssr,
            "mean_tbt_s": self.mean_tbt,
            "kvc_util": self.kvc_utilization,
            "kvc_alloc": self.kvc_allocated,
            "gpu_util": self.gpu_utilization,
            "fwd_size": self.mean_forward_size,
            "alloc_fail_rate": self.alloc_failure_rate,
            "sched_overhead": self.sched_overhead_frac,
            "preempt_swap": float(self.n_preempt_swap),
            "preempt_free": float(self.n_preempt_free),
            "underprov": float(self.n_underprov),
            "completed": float(len(self.completed)),
        }
