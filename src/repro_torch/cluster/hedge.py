"""Straggler-aware hedged execution: config + lifecycle ledger.

A *hedge* races a stalled (or suspect-hosted) request on a second
instance: the primary keeps running, a clone starts on the best live
peer under a fresh delivery epoch, and the first terminal transition
wins. The loser is cancelled through the megastep-safe abort path and
its host is *fenced* for that request — any completion it produces
afterwards (a partitioned zombie finishing into the void) is counted,
never delivered.

``HedgeCoordinator`` is the backend-agnostic half: it owns the
per-request progress watchdog (:class:`~repro_torch.core.pressure.
StragglerWatchdog`) and the lifecycle ledger, and it *enforces* the
hedging invariants at transition time rather than trusting the backends
to get them right:

  * at most one winner per request, ever;
  * no hedge launched for a terminal (or already-hedged-out) request;
  * delivery epochs strictly increase per request — an epoch is never
    reused, so a stale clone's messages can always be fenced by key;
  * a fenced loser never delivers downstream — ``deliverable`` answers
    the receiving side's "may this host still write this request?".

Both cluster backends (``EngineFleet`` real engines, ``ClusterSim``
discrete-event) drive the same coordinator, so one chaos schedule
produces the same hedge decisions on either. With ``enabled=False`` the
coordinator never issues a verdict and the backends take their legacy
paths untouched — hedging off is bitwise-unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from ..core.pressure import StragglerWatchdog


class HedgeViolation(AssertionError):
    """A hedging lifecycle invariant was broken (double winner, reused
    epoch, hedge on a terminal request, delivery past a fence)."""


@dataclass
class HedgeConfig:
    """Knobs for the hedged-execution tier.

    Stall thresholds are ``*_factor`` multiples of a rolling
    EWMA-smoothed ``quantile`` of observed TTFT / inter-token gaps
    (see :class:`~repro_torch.core.pressure.StragglerWatchdog`), floored by
    ``floor`` so a cold estimator never hair-triggers. ``on_suspect``
    additionally hedges any tracked request whose host the failure
    detector marks SUSPECT — the partition case, where the zombie keeps
    *appearing* to make progress locally while the client sees nothing.
    ``max_hedges`` bounds clones per request (one is the classic
    tail-latency hedge; more buys nothing under greedy decoding)."""
    enabled: bool = True
    ttft_factor: float = 3.0
    rate_factor: float = 3.0
    quantile: float = 0.9
    window: int = 64
    min_samples: int = 4
    floor: float = 4.0
    alpha: float = 0.5
    on_suspect: bool = True
    max_hedges: int = 1

    def make_watchdog(self) -> StragglerWatchdog:
        return StragglerWatchdog(
            ttft_factor=self.ttft_factor, rate_factor=self.rate_factor,
            quantile=self.quantile, window=self.window,
            min_samples=self.min_samples, floor=self.floor,
            alpha=self.alpha)


@dataclass
class _HedgeState:
    """One in-flight hedge: the clone's host + delivery epoch."""
    clone_host: int
    epoch: tuple
    reason: str


class HedgeCoordinator:
    """Lifecycle ledger for hedged requests (see module docstring).

    ``key`` identifies one logical request on the backend's terms
    (``id(GenRequest)`` for the fleet, ``rid`` for the sim); ``host`` is
    an instance id. The coordinator never touches engines or transports
    — backends ask it *whether* to hedge (``want_hedge``), tell it what
    happened (``launch`` / ``resolve`` / ``mark_terminal``), and consult
    it at the delivery boundary (``deliverable`` / ``record_fenced``).
    """

    def __init__(self, cfg: Optional[HedgeConfig] = None):
        self.cfg = cfg or HedgeConfig()
        self.watchdog = self.cfg.make_watchdog()
        self._active: Dict[object, _HedgeState] = {}
        self._terminal: Set[object] = set()
        self._winner: Dict[object, str] = {}      # key -> primary|clone
        self._n_hedges: Dict[object, int] = {}    # clones launched so far
        self._last_epoch: Dict[object, tuple] = {}
        self._fenced: Set[Tuple[object, int]] = set()   # (key, host)
        self.n_fired = 0
        self.n_won = 0           # clone beat the primary
        self.n_cancelled = 0     # loser cancelled (either side)
        self.n_fenced = 0        # post-fence completions counted, dropped

    # -- watchdog feed -------------------------------------------------- #
    def track(self, key, now: float) -> None:
        if key not in self._terminal:
            self.watchdog.track(key, now)

    def observe_progress(self, key, tokens: int, now: float) -> None:
        self.watchdog.observe_progress(key, tokens, now)

    def reset_progress(self, key, tokens: int, now: float) -> None:
        if self.watchdog.tracked(key):
            self.watchdog.reset(key, tokens, now)

    # -- decisions ------------------------------------------------------ #
    def want_hedge(self, key, now: float,
                   host_suspect: bool = False) -> Optional[str]:
        """Reason to hedge ``key`` now (``"ttft-stall"`` /
        ``"rate-stall"`` / ``"suspect"``), or None. Never fires when
        disabled, for a terminal request, for one already racing a
        clone, or past the per-request hedge budget."""
        if not self.cfg.enabled or key in self._terminal \
                or key in self._active \
                or self._n_hedges.get(key, 0) >= self.cfg.max_hedges:
            return None
        stall = self.watchdog.stalled(key, now)
        if stall is not None:
            return stall
        if host_suspect and self.cfg.on_suspect \
                and self.watchdog.tracked(key):
            return "suspect"
        return None

    # -- lifecycle transitions (invariant-enforcing) -------------------- #
    def launch(self, key, epoch: tuple, clone_host: int,
               reason: str) -> None:
        """Record a clone launched for ``key`` on ``clone_host`` under
        delivery ``epoch``. Raises :class:`HedgeViolation` on a hedge
        for a terminal/resolved request, a concurrent second clone, or
        a non-increasing epoch."""
        if key in self._terminal or key in self._winner:
            raise HedgeViolation(f"hedge launched for terminal request "
                                 f"{key!r}")
        if key in self._active:
            raise HedgeViolation(f"second concurrent clone for {key!r}")
        if self._n_hedges.get(key, 0) >= self.cfg.max_hedges:
            raise HedgeViolation(f"hedge budget exhausted for {key!r}")
        last = self._last_epoch.get(key)
        if last is not None and epoch <= last:
            raise HedgeViolation(f"delivery epoch reused for {key!r}: "
                                 f"{epoch!r} after {last!r}")
        self._last_epoch[key] = epoch
        self._active[key] = _HedgeState(clone_host=clone_host,
                                        epoch=epoch, reason=reason)
        self._n_hedges[key] = self._n_hedges.get(key, 0) + 1
        self.n_fired += 1

    def resolve(self, key, winner: str, primary_host: int) -> None:
        """First terminal transition for a hedged request: ``winner`` is
        ``"primary"`` or ``"clone"``. The loser's host is fenced for
        this request. A second resolution raises — at most one winner,
        ever."""
        assert winner in ("primary", "clone"), winner
        st = self._active.pop(key, None)
        if key in self._winner:
            raise HedgeViolation(f"second winner for {key!r}: "
                                 f"{winner} after {self._winner[key]}")
        if st is None:
            raise HedgeViolation(f"resolve for {key!r} with no clone in "
                                 f"flight")
        self._winner[key] = winner
        self._terminal.add(key)
        self.watchdog.forget(key)
        loser = st.clone_host if winner == "primary" else primary_host
        self._fenced.add((key, loser))
        self.n_cancelled += 1
        if winner == "clone":
            self.n_won += 1

    def abandon(self, key) -> None:
        """The clone died without completing (its host crashed, or a
        deadline abort got it first): the race dissolves with no winner.
        The clone's host is fenced for this request; the primary keeps
        running, and the request may hedge again while budget remains."""
        st = self._active.pop(key, None)
        if st is None:
            raise HedgeViolation(f"abandon for {key!r} with no clone in "
                                 f"flight")
        self._fenced.add((key, st.clone_host))
        self.n_cancelled += 1

    def mark_terminal(self, key) -> None:
        """The request reached a terminal state with no clone in flight
        (the common, unhedged path). Idempotent; after this no hedge can
        launch for ``key``."""
        self._terminal.add(key)
        self.watchdog.forget(key)

    # -- delivery-boundary fencing -------------------------------------- #
    def deliverable(self, key, host: int) -> bool:
        """May ``host`` still deliver output for ``key``? False once the
        host lost the race — its late completions are fenced."""
        return (key, host) not in self._fenced

    def record_fenced(self, key, host: int) -> None:
        """Count one completion/emission arriving past the fence. The
        caller must drop it (counted, never delivered); delivering it
        anyway is the double-delivery bug this tier exists to prevent."""
        if self.deliverable(key, host):
            raise HedgeViolation(f"fenced completion recorded for "
                                 f"un-fenced ({key!r}, host {host})")
        self.n_fenced += 1

    # -- introspection -------------------------------------------------- #
    def active(self, key) -> bool:
        return key in self._active

    def clone_host(self, key) -> Optional[int]:
        st = self._active.get(key)
        return None if st is None else st.clone_host

    def clone_epoch(self, key) -> Optional[tuple]:
        st = self._active.get(key)
        return None if st is None else st.epoch

    def winner(self, key) -> Optional[str]:
        return self._winner.get(key)

    def counters(self) -> Dict[str, int]:
        return {
            "hedges_fired": self.n_fired,
            "hedges_won": self.n_won,
            "hedges_cancelled": self.n_cancelled,
            "fenced_completions": self.n_fenced,
            "stall_verdicts": self.watchdog.n_stall_verdicts,
        }

    def publish_metrics(self, registry) -> None:
        """Publish the ``hedge_*`` metric family into a ``repro_torch.obs``
        registry (both backends call this from their metrics hooks)."""
        registry.counter("hedge_fired_total",
                         "hedge clones launched") \
            .unlabeled.inc_to(self.n_fired)
        registry.counter("hedge_won_total",
                         "hedge clones that beat their primary") \
            .unlabeled.inc_to(self.n_won)
        registry.counter("hedge_cancelled_total",
                         "hedge losers cancelled (either side)") \
            .unlabeled.inc_to(self.n_cancelled)
        registry.counter("hedge_fenced_completions_total",
                         "completions arriving past a fence: counted, "
                         "never delivered") \
            .unlabeled.inc_to(self.n_fenced)
        registry.counter("hedge_stall_verdicts_total",
                         "watchdog stall verdicts (TTFT + token-rate)") \
            .unlabeled.inc_to(self.watchdog.n_stall_verdicts)
