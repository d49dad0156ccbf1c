"""Watermark-guarded KVC pressure controller.

``WatermarkGuard`` turns raw KVC occupancy into a stable two-state
backpressure signal: an :class:`EWMA` smooths the per-step occupancy,
and high/low watermarks with hysteresis (plus a patience count on the
way up) decide when the engine should proactively swap waiting GTs out
to the host pool versus release them back for admission. Hysteresis is
what keeps the ladder from thrashing — a single controller decision
covers the whole span between the watermarks.

The controller is deterministic: state depends only on the sequence of
observed occupancies, and the engine only feeds it at megastep-window
boundaries (occupancy is frozen inside a certified window), so a K=8
fused run observes exactly the same sequence as a K=1 run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class EWMA:
    """Exponentially-weighted moving average, seeded by first sample."""
    alpha: float = 0.5
    value: float = 0.0
    _primed: bool = False

    def update(self, x: float) -> float:
        if not self._primed:
            self.value = float(x)
            self._primed = True
        else:
            self.value += self.alpha * (float(x) - self.value)
        return self.value


@dataclass
class WatermarkGuard:
    """Hysteresis state machine over EWMA'd KVC occupancy.

    ``observe(frac)`` returns the current state: ``True`` means the
    guard is in *pressure* mode (swap out, hold admissions), ``False``
    means relaxed (swap back in). Entry requires the smoothed occupancy
    to sit above ``high`` for ``patience`` consecutive observations;
    exit requires it to fall below ``low`` (no patience on the way
    down — releasing pressure late is the expensive direction).
    """
    high: float = 0.92
    low: float = 0.70
    alpha: float = 0.5
    patience: int = 2
    ewma: EWMA = field(default_factory=EWMA)
    pressure: bool = False
    _over: int = 0              # consecutive observations above high
    n_trips: int = 0            # relaxed -> pressure transitions
    n_releases: int = 0         # pressure -> relaxed transitions

    def __post_init__(self):
        assert 0.0 <= self.low <= self.high <= 1.0, (self.low, self.high)
        self.ewma.alpha = self.alpha

    def observe(self, occupied_frac: float) -> bool:
        v = self.ewma.update(occupied_frac)
        if not self.pressure:
            if v >= self.high:
                self._over += 1
                if self._over >= self.patience:
                    self.pressure = True
                    self.n_trips += 1
            else:
                self._over = 0
        elif v <= self.low:
            self.pressure = False
            self._over = 0
            self.n_releases += 1
        return self.pressure


@dataclass
class RollingQuantile:
    """Windowed quantile smoothed by an :class:`EWMA` — the same
    deterministic smoothing idiom :class:`WatermarkGuard` uses for KVC
    occupancy, applied to latency samples. ``value()`` is None until
    ``min_samples`` observations arrived: a cold estimator must never
    produce a threshold (the consumer treats None as "no verdict")."""
    q: float = 0.9
    window: int = 64
    min_samples: int = 4
    alpha: float = 0.5
    samples: List[float] = field(default_factory=list)
    ewma: EWMA = field(default_factory=EWMA)
    n_observed: int = 0

    def __post_init__(self):
        assert 0.0 < self.q <= 1.0, self.q
        self.ewma.alpha = self.alpha

    def observe(self, x: float) -> None:
        self.n_observed += 1
        self.samples.append(float(x))
        if len(self.samples) > self.window:
            del self.samples[:len(self.samples) - self.window]
        s = sorted(self.samples)
        k = min(len(s) - 1, int(self.q * len(s)))
        self.ewma.update(s[k])

    def value(self) -> Optional[float]:
        if self.n_observed < self.min_samples:
            return None
        return self.ewma.value


class StragglerWatchdog:
    """Per-request progress watchdog: TTFT-stall and token-rate stall.

    The cluster backends feed it host-visible progress (tokens drained
    to the client record, on the backend's iteration/event clock) and
    completed-stream latency samples; ``stalled(key, now)`` answers
    whether a tracked request has gone quiet long enough to justify a
    hedge clone. Thresholds are ``factor`` multiples of a rolling
    EWMA-smoothed quantile of *observed* latencies (TTFT for requests
    that have not produced a first token, inter-token gap for ones
    mid-decode), floored by ``floor`` so a cold or noisy estimate never
    produces a hair-trigger hedge. With no samples yet there is no
    threshold and no verdict — a fresh fleet never hedges.

    Deterministic: state depends only on the observation sequence, so a
    seeded chaos run reproduces its hedge decisions bit-for-bit.
    """

    def __init__(self, ttft_factor: float = 3.0, rate_factor: float = 3.0,
                 quantile: float = 0.9, window: int = 64,
                 min_samples: int = 4, floor: float = 4.0,
                 alpha: float = 0.5):
        self.ttft_factor = ttft_factor
        self.rate_factor = rate_factor
        self.floor = floor
        self._ttft = RollingQuantile(q=quantile, window=window,
                                     min_samples=min_samples, alpha=alpha)
        self._gap = RollingQuantile(q=quantile, window=window,
                                    min_samples=min_samples, alpha=alpha)
        # key -> (t_started, tokens_seen, t_last_progress)
        self._prog: Dict[object, Tuple[float, int, float]] = {}
        self.n_stall_verdicts = 0

    # -- tracking ------------------------------------------------------- #
    def track(self, key, now: float) -> None:
        """Start (or restart) watching one request from ``now``."""
        self._prog[key] = (now, 0, now)

    def forget(self, key) -> None:
        self._prog.pop(key, None)

    def reset(self, key, tokens: int, now: float) -> None:
        """Re-arm the stall clocks after a re-route: progress so far is
        kept, the silence timer restarts — the new host deserves a full
        threshold window before being called a straggler."""
        self._prog[key] = (now, int(tokens), now)

    def tracked(self, key) -> bool:
        return key in self._prog

    def observe_progress(self, key, tokens: int, now: float) -> None:
        """Record host-visible progress: ``tokens`` drained so far. The
        first token closes the request's TTFT sample; each further token
        feeds the inter-token gap estimator (averaged over the tokens
        that arrived in the same drain batch)."""
        st = self._prog.get(key)
        if st is None:
            return
        t0, seen, t_last = st
        if tokens <= seen:
            return
        if seen == 0:
            self._ttft.observe(now - t0)
            seen_new = tokens
            if tokens > 1:
                self._gap.observe(0.0)   # batch-drained burst: zero gap
        else:
            self._gap.observe((now - t_last) / (tokens - seen))
            seen_new = tokens
        self._prog[key] = (t0, seen_new, now)

    # -- thresholds / verdicts ------------------------------------------ #
    def ttft_threshold(self) -> Optional[float]:
        v = self._ttft.value()
        return None if v is None else max(self.floor, self.ttft_factor * v)

    def gap_threshold(self) -> Optional[float]:
        v = self._gap.value()
        return None if v is None else max(self.floor, self.rate_factor * v)

    def stalled(self, key, now: float) -> Optional[str]:
        """``"ttft-stall"`` / ``"rate-stall"`` when the request's silence
        exceeds the current threshold, else None (including: not tracked,
        or thresholds still cold)."""
        st = self._prog.get(key)
        if st is None:
            return None
        t0, seen, t_last = st
        if seen == 0:
            thr = self.ttft_threshold()
            if thr is not None and now - t0 > thr:
                self.n_stall_verdicts += 1
                return "ttft-stall"
            return None
        thr = self.gap_threshold()
        if thr is not None and now - t_last > thr:
            self.n_stall_verdicts += 1
            return "rate-stall"
        return None
