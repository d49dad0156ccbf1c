"""Goodput-driven autoscaling with hysteresis.

The autoscaler watches SLO attainment (fraction of recently completed
requests that met their deadline — the per-request view of the paper's
goodput metric) and decides when to add an instance or drain one. It is
pure decision logic: the cluster backends (``ClusterSim`` /
``EngineFleet``) feed it observations and execute its actions, so the same
policy — and the same hysteresis tests — cover both.

Flap protection is layered (a bare threshold controller oscillates on any
step load change: attainment dips → scale up → attainment recovers → scale
down → dips again):

  * dual thresholds  — scale up below ``slo_low``, consider scaling down
    only above ``slo_high`` (the dead band between them absorbs noise);
  * patience         — a breach must persist for ``patience`` consecutive
    evaluations before acting;
  * cooldown         — after any action, hold for ``cooldown`` time units
    (new capacity needs time to show up in the attainment window);
  * load guard       — scale down only when the survivors could absorb the
    drained instance's load: mean allocated-KVC fraction projected onto
    n-1 instances must stay under ``down_load_cap``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class AutoscaleConfig:
    slo_low: float = 0.85          # scale up when attainment drops below
    slo_high: float = 0.98         # scale down only above (dead band)
    window: int = 32               # completions per attainment estimate
    min_window: int = 8            # don't act on fewer observations
    patience: int = 2              # consecutive breaches before acting
    cooldown: float = 50.0         # time units between actions
    down_load_cap: float = 0.70    # projected per-survivor load ceiling
    min_instances: int = 1
    max_instances: int = 8


class GoodputAutoscaler:
    """Feed it completions (``record``) and poll it (``decide``)."""

    def __init__(self, cfg: Optional[AutoscaleConfig] = None):
        self.cfg = cfg or AutoscaleConfig()
        self._met: List[bool] = []          # rolling completion window
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t = -float("inf")
        self.events: List[Tuple[float, int]] = []   # (t, +1/-1) log
        # registry-sourced mode (bind_registry): completions publish into
        # obs counters and attainment is reconstructed from that series
        self._c_met = None
        self._c_miss = None
        self._series: List[Tuple[float, float]] = []  # (total, met) reads
        self._baseline: Tuple[float, float] = (0.0, 0.0)

    # ------------------------------------------------------------------ #
    def bind_registry(self, registry) -> None:
        """Make a ``repro_torch.obs`` registry the autoscaler's input signal:
        every ``record`` publishes into
        ``autoscaler_completions_total{met=...}`` and the attainment
        window is reconstructed from that registry time series —
        cumulative-counter deltas over the last ``window`` completions,
        floored at the invalidation baseline — instead of a private
        rolling list. Decisions are identical to the unbound mode; the
        metrics plane simply becomes the source of truth, so the same
        series dashboards plot is the one the controller acts on."""
        fam = registry.counter("autoscaler_completions_total",
                               "completions observed by the autoscaler",
                               ("met",))
        self._c_met = fam.labels(met="true")
        self._c_miss = fam.labels(met="false")
        self._series = []
        self._baseline = (self._c_met.value + self._c_miss.value,
                          self._c_met.value)
        self._met.clear()

    def record(self, met_slo: bool) -> None:
        if self._c_met is not None:
            (self._c_met if met_slo else self._c_miss).inc()
            tot = self._c_met.value + self._c_miss.value
            self._series.append((tot, self._c_met.value))
            if len(self._series) > self.cfg.window + 1:
                del self._series[:len(self._series) - self.cfg.window - 1]
            return
        self._met.append(met_slo)
        if len(self._met) > self.cfg.window:
            del self._met[:len(self._met) - self.cfg.window]

    def _window_bounds(self) -> Optional[Tuple[float, float, float, float]]:
        """Registry mode: (then_total, then_met, now_total, now_met) for
        the active window — the last ``window`` readings past the
        baseline."""
        now = self._series[-1] if self._series else self._baseline
        if now[0] <= self._baseline[0]:
            return None
        then = self._series[-1 - self.cfg.window] \
            if len(self._series) > self.cfg.window else self._baseline
        if then[0] < self._baseline[0]:
            then = self._baseline
        return then[0], then[1], now[0], now[1]

    @property
    def window_len(self) -> int:
        if self._c_met is not None:
            b = self._window_bounds()
            return 0 if b is None else int(b[2] - b[0])
        return len(self._met)

    @property
    def attainment(self) -> Optional[float]:
        if self._c_met is not None:
            b = self._window_bounds()
            if b is None:
                return None
            then_t, then_m, now_t, now_m = b
            n = now_t - then_t
            if n < self.cfg.min_window:
                return None
            return (now_m - then_m) / n
        if len(self._met) < self.cfg.min_window:
            return None
        return sum(self._met) / len(self._met)

    # ------------------------------------------------------------------ #
    def decide(self, t: float, n_live: int, n_draining: int = 0,
               load_frac: float = 1.0, can_drain: bool = True) -> int:
        """Returns +1 (add an instance), -1 (drain one), or 0 (hold).

        ``n_live`` counts routable instances (draining ones excluded),
        ``load_frac`` is the mean allocated-KVC fraction across them,
        ``can_drain`` is whether the caller actually has a drain victim
        (e.g. a unified-role instance). Action state (cooldown, window
        reset, event log) commits only on an executable decision — a
        capacity- or victim-blocked breach must not start a phantom
        cooldown that suppresses later legitimate actions.
        """
        cfg = self.cfg
        att = self.attainment
        if att is None:
            return 0
        if t - self._last_action_t < cfg.cooldown:
            # the previous action hasn't had time to show up in the
            # window: hold AND don't accumulate breaches against stale data
            self._up_streak = self._down_streak = 0
            return 0
        if att < cfg.slo_low:
            if n_live + n_draining >= cfg.max_instances:
                return 0                     # at capacity: nothing to do
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= cfg.patience:
                self._act(t, +1)
                return +1
            return 0
        if att > cfg.slo_high and n_live > cfg.min_instances and can_drain:
            projected = load_frac * n_live / max(1, n_live - 1)
            if projected <= cfg.down_load_cap:
                self._down_streak += 1
                self._up_streak = 0
                if self._down_streak >= cfg.patience:
                    self._act(t, -1)
                    return -1
                return 0
        self._up_streak = self._down_streak = 0
        return 0

    def publish_metrics(self, registry) -> None:
        """Publish attainment + action counters into a ``repro_torch.obs``
        registry."""
        att = self.attainment
        registry.gauge("autoscaler_attainment_ratio",
                       "rolling SLO attainment (None -> -1: window too "
                       "small to act on)") \
            .unlabeled.set(-1.0 if att is None else att)
        registry.gauge("autoscaler_window_completions",
                       "completions in the attainment window") \
            .unlabeled.set(self.window_len)
        up = sum(1 for _, d in self.events if d > 0)
        fam = registry.counter("autoscaler_actions_total",
                               "scale actions executed", ("direction",))
        fam.labels(direction="up").inc_to(up)
        fam.labels(direction="down").inc_to(len(self.events) - up)

    def invalidate(self) -> None:
        """Discard the attainment window and breach streaks — called on an
        instance crash: the window's completions reflect the pre-crash
        capacity, and acting on them would double-count the failure."""
        self._reset_window()
        self._up_streak = self._down_streak = 0

    def _reset_window(self) -> None:
        """Start the next attainment estimate fresh. In registry mode the
        counters keep their full history (a monotonic series for the
        dashboards); only the controller's baseline moves."""
        self._met.clear()
        if self._c_met is not None:
            self._baseline = (self._c_met.value + self._c_miss.value,
                              self._c_met.value)

    def _act(self, t: float, delta: int) -> None:
        self._last_action_t = t
        self._up_streak = self._down_streak = 0
        # an action invalidates the window: completions in it reflect the
        # old capacity, so start the next estimate fresh
        self._reset_window()
        self.events.append((t, delta))
