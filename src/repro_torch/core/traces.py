"""Synthetic trace generators calibrated to the paper's Table 2.

The real Alpaca / ShareGPT / BookCorpus request logs are not available in
this offline environment, so we generate lognormal prompt/response lengths
clipped to the table's min/max, with Poisson arrivals at the table's rate.
True response length is correlated with prompt length through a latent
factor so that a learned predictor has signal (and a noisy-oracle predictor
can be calibrated to the paper's reported accuracies).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .request import Request


@dataclass(frozen=True)
class TraceSpec:
    name: str
    in_mean: float
    in_min: int
    in_max: int
    out_mean: float
    out_min: int
    out_max: int
    rate: float                      # requests / s (Poisson)
    in_sigma: float = 0.9            # lognormal shape
    out_sigma: float = 0.7
    rl_corr: float = 0.45            # prompt→response latent correlation


ALPACA = TraceSpec("alpaca", 19.31, 9, 2470, 58.41, 13, 292, 36.0,
                   in_sigma=0.6)
SHAREGPT = TraceSpec("sharegpt", 161.31, 16, 3200, 337.99, 19, 991, 28.0)
BOOKCORPUS = TraceSpec("bookcorpus", 1952.11, 18, 2048, 681.2, 32, 1041, 1.2,
                       in_sigma=0.35)

TRACES = {t.name: t for t in (ALPACA, SHAREGPT, BOOKCORPUS)}


def _lognormal_mean(mean: float, sigma: float, rng: np.random.Generator,
                    n: int) -> np.ndarray:
    mu = math.log(mean) - 0.5 * sigma * sigma
    return rng.lognormal(mu, sigma, size=n)


def generate(spec: TraceSpec, n: int, seed: int = 0,
             rate: Optional[float] = None,
             slo_scale: float = 2.0,
             t_p: float = 0.06, t_g: float = 0.04) -> List[Request]:
    """Generate ``n`` requests. SLO deadline follows §4:
    arrival + slo_scale * (t_p + t_g * RL)."""
    rng = np.random.default_rng(seed)
    rate = rate if rate is not None else spec.rate

    plen = np.clip(_lognormal_mean(spec.in_mean, spec.in_sigma, rng, n),
                   spec.in_min, spec.in_max).astype(int)
    # correlated latent: z shared between prompt and response
    z = (np.log(plen) - np.mean(np.log(plen))) / (np.std(np.log(plen)) + 1e-9)
    eps = rng.normal(size=n)
    mix = spec.rl_corr * z + math.sqrt(1 - spec.rl_corr ** 2) * eps
    mu = math.log(spec.out_mean) - 0.5 * spec.out_sigma ** 2
    rl = np.clip(np.exp(mu + spec.out_sigma * mix),
                 spec.out_min, spec.out_max).astype(int)

    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = np.cumsum(gaps)

    reqs = []
    for i in range(n):
        deadline = arrivals[i] + slo_scale * (t_p + t_g * float(rl[i]))
        reqs.append(Request(rid=i, prompt_len=int(plen[i]),
                            true_rl=int(rl[i]), arrival=float(arrivals[i]),
                            slo_deadline=float(deadline)))
    return reqs


@dataclass(frozen=True)
class DiurnalSpec:
    """Inhomogeneous-Poisson arrival schedule for the trace replayer:
    a sinusoidal day/night ramp with superimposed Poisson burst windows.

    The instantaneous rate at time ``t`` is

        rate(t) = base_rate * (1 + diurnal_amp * sin(2*pi*t/period - pi/2))
                  * (burst_mult if t is inside a burst window else 1)

    — the phase shift puts the trough at t=0 (replays start at "night"),
    the peak at period/2. Burst windows themselves arrive as a Poisson
    process with rate ``burst_rate`` and exponential durations, modelling
    flash crowds on top of the daily cycle.
    """
    period: float = 600.0            # one synthetic "day", in trace time
    diurnal_amp: float = 0.6         # peak/trough swing (0 => homogeneous)
    burst_rate: float = 1 / 120.0    # burst windows per unit time
    burst_duration: float = 15.0     # mean burst length (exponential)
    burst_mult: float = 3.0          # rate multiplier inside a burst


def diurnal_arrivals(n: int, base_rate: float, spec: DiurnalSpec,
                     rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival times from the inhomogeneous Poisson process above,
    via thinning (Lewis & Shedler): draw candidates at the peak rate
    ``base_rate * (1 + amp) * burst_mult`` and accept each with
    probability rate(t)/peak — exact for any bounded rate function."""
    if spec.diurnal_amp < 0 or spec.diurnal_amp > 1:
        raise ValueError("diurnal_amp must be in [0, 1]")
    peak = base_rate * (1 + spec.diurnal_amp) * max(1.0, spec.burst_mult)
    arrivals = np.empty(n)
    got = 0
    t = 0.0
    burst_until = -1.0
    next_burst = rng.exponential(1.0 / spec.burst_rate) \
        if spec.burst_rate > 0 else float("inf")
    while got < n:
        t += rng.exponential(1.0 / peak)
        while t >= next_burst:               # open burst windows in order
            burst_until = next_burst + rng.exponential(spec.burst_duration)
            next_burst += rng.exponential(1.0 / spec.burst_rate)
        lam = base_rate * (1 + spec.diurnal_amp
                           * math.sin(2 * math.pi * t / spec.period
                                      - math.pi / 2))
        if t <= burst_until:
            lam *= spec.burst_mult
        if rng.uniform() * peak <= lam:
            arrivals[got] = t
            got += 1
    return arrivals


def generate_diurnal(spec: TraceSpec, n: int, seed: int = 0,
                     rate: Optional[float] = None,
                     diurnal: Optional[DiurnalSpec] = None,
                     slo_scale: float = 2.0,
                     t_p: float = 0.06, t_g: float = 0.04) -> List[Request]:
    """Like ``generate`` but with diurnal-ramp + Poisson-burst arrivals
    (heavy-tailed lengths come from the lognormal spec as before). Used
    by ``benchmarks/trace_replay.py`` for the 100k-request replays."""
    base = generate(spec, n, seed=seed, rate=rate, slo_scale=slo_scale,
                    t_p=t_p, t_g=t_g)
    rng = np.random.default_rng(seed + 1)
    arrivals = diurnal_arrivals(
        n, rate if rate is not None else spec.rate,
        diurnal or DiurnalSpec(), rng)
    reqs = []
    for r, t in zip(base, arrivals):
        deadline = float(t) + slo_scale * (t_p + t_g * float(r.true_rl))
        reqs.append(Request(rid=r.rid, prompt_len=r.prompt_len,
                            true_rl=r.true_rl, arrival=float(t),
                            slo_deadline=deadline))
    return reqs
