"""Typed metrics registry: Counter / Gauge / Histogram families with
Prometheus-style names and label sets.

One registry is the single publication surface every subsystem writes
into (``ServingEngine``, the EconoServe scheduler, ``BlockKVC``, routers,
``FailureDetector``, ``GoodputAutoscaler``) — replacing the ad-hoc dict
scraping each benchmark used to hand-roll. Naming follows
``<subsystem>_<noun>_<unit>`` (see ROADMAP.md appendix); counters end in
``_total``.

Design constraints (all hot-path callers are engine iteration loops):

  * pure host-side Python — publishing never touches a device value, so
    a metrics-on run is bitwise-identical to metrics-off with zero added
    blocking syncs (hard-gated by ``hotpath_micro --check``);
  * label-set identity — ``family.labels(a="1", b="2")`` returns the
    *same* child object for the same label values regardless of keyword
    order, so publishers can cache children and publish by attribute;
  * counters are monotone — ``inc`` rejects negative amounts and
    ``inc_to`` rejects regressions, so concurrent publishers can only
    ever move a counter forward;
  * snapshots are immutable — ``registry.snapshot()`` deep-freezes every
    family into tuples/mapping-proxies, so a stall post-mortem captured
    at raise time cannot be mutated by later iterations.

Histogram bucket semantics match Prometheus ``le`` (less-or-equal):
a value exactly on a bucket edge lands in that (low-side) bucket, and
the implicit ``+Inf`` bucket conserves the total observation count.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from types import MappingProxyType
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "Snapshot", "FamilySnapshot", "HistogramValue",
           "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0)


def _validate_name(name: str) -> str:
    assert name and name[0].isalpha() and all(
        c.isalnum() or c == "_" for c in name), \
        f"metric name {name!r} must match [a-zA-Z][a-zA-Z0-9_]*"
    return name


class Counter:
    """Monotonically non-decreasing value. ``inc`` takes a per-counter
    lock: a bare ``+=`` is a read-modify-write, and a lost update under
    concurrent publishers can store a *smaller* value than a reader
    already saw — breaking monotonicity, the one property counters
    promise. The lock is uncontended on the single-threaded engine hot
    path, so it costs one atomic acquire."""
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: Union[int, float] = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0: {amount}")
        with self._lock:
            self.value += amount

    def inc_to(self, total: Union[int, float]) -> None:
        """Advance to an externally-maintained running total (the engine's
        own ``n_*`` ints). A regression means two publishers disagree —
        refuse it rather than silently un-counting."""
        with self._lock:
            if total < self.value:
                raise ValueError(
                    f"counter cannot regress: {self.value} -> {total}")
            self.value = float(total)


class Gauge:
    """Point-in-time value; free to move both ways."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: Union[int, float]) -> None:
        self.value = float(value)

    def inc(self, amount: Union[int, float] = 1) -> None:
        self.value += amount

    def dec(self, amount: Union[int, float] = 1) -> None:
        self.value -= amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics)."""
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: Union[int, float]) -> None:
        v = float(value)
        lo, hi = 0, len(self.edges)            # first edge with v <= edge:
        while lo < hi:                         # boundary values land in the
            mid = (lo + hi) // 2               # low-side bucket
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += v
        self.count += 1


@dataclass(frozen=True)
class HistogramValue:
    """Frozen histogram sample: cumulative (le, count) pairs ending at
    +Inf; the +Inf cumulative count always equals ``count``."""
    buckets: Tuple[Tuple[float, int], ...]
    sum: float
    count: int


class _Family:
    """One named metric + its per-label-set children."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = _validate_name(name)
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self.buckets)

    def labels(self, **labelvalues):
        """Child for one label-value set. Identity is guaranteed: the
        same values (any keyword order) return the same object."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            # setdefault is atomic in CPython: when two publishers race
            # to create the same child, both get the one that won
            child = self._children.setdefault(key, self._make_child())
        return child

    @property
    def unlabeled(self):
        """The single child of a label-less family."""
        assert not self.labelnames, \
            f"{self.name} declares labels {self.labelnames}"
        return self.labels()


@dataclass(frozen=True)
class FamilySnapshot:
    name: str
    kind: str
    help: str
    labelnames: Tuple[str, ...]
    # ((labels mapping, value-or-HistogramValue), ...)
    samples: Tuple[Tuple[Mapping[str, str],
                         Union[float, HistogramValue]], ...]


@dataclass(frozen=True)
class Snapshot:
    """Immutable point-in-time copy of a whole registry."""
    families: Tuple[FamilySnapshot, ...]

    def get(self, name: str, **labels):
        """Value of one sample (float, or HistogramValue)."""
        for fam in self.families:
            if fam.name != name:
                continue
            want = {k: str(v) for k, v in labels.items()}
            for lbls, value in fam.samples:
                if dict(lbls) == want:
                    return value
            raise KeyError(f"{name}: no sample with labels {want}")
        raise KeyError(name)

    def flat(self) -> Dict[str, Union[float, int]]:
        """``name{k="v",...}`` -> scalar, histograms expanded into
        ``_bucket{le=...}`` / ``_sum`` / ``_count`` series — the exact
        sample set the Prometheus text exporter renders."""
        out: Dict[str, Union[float, int]] = {}
        for fam in self.families:
            for lbls, value in fam.samples:
                base = _render_labels(lbls)
                if isinstance(value, HistogramValue):
                    for le, c in value.buckets:
                        out[_suffixed(fam.name + "_bucket", lbls,
                                      le=le)] = c
                    out[fam.name + "_sum" + base] = value.sum
                    out[fam.name + "_count" + base] = value.count
                else:
                    out[fam.name + base] = value
        return out


def _render_labels(lbls: Mapping[str, str], **extra) -> str:
    items = list(lbls.items()) + [
        (k, "+Inf" if v == float("inf") else _fmt_num(v))
        for k, v in extra.items()]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def _suffixed(name: str, lbls: Mapping[str, str], **extra) -> str:
    return name + _render_labels(lbls, **extra)


def _fmt_num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class MetricsRegistry:
    """Factory + namespace for metric families.

    Re-declaring an existing name returns the existing family when the
    (kind, labelnames, buckets) signature matches and raises otherwise —
    two subsystems can share a family but never silently retype one.
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------------ #
    def _declare(self, name: str, kind: str, help: str,
                 labelnames: Iterable[str],
                 buckets: Optional[Tuple[float, ...]] = None) -> _Family:
        labelnames = tuple(labelnames)
        fam = self._families.get(name)
        if fam is not None:
            if (fam.kind, fam.labelnames, fam.buckets) != \
                    (kind, labelnames, buckets):
                raise ValueError(
                    f"metric {name!r} re-declared as {kind}"
                    f"{labelnames} (was {fam.kind}{fam.labelnames})")
            return fam
        fam = _Family(name, kind, help, labelnames, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._declare(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._declare(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> _Family:
        edges = tuple(sorted(float(b) for b in buckets))
        assert edges and all(e == e for e in edges) \
            and edges[-1] != float("inf"), \
            "buckets must be finite (+Inf is implicit)"
        return self._declare(name, "histogram", help, (), edges) \
            if not labelnames else \
            self._declare(name, "histogram", help, labelnames, edges)

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Snapshot:
        fams = []
        for fam in self._families.values():
            samples = []
            for key, child in fam._children.items():
                lbls = MappingProxyType(dict(zip(fam.labelnames, key)))
                if isinstance(child, Histogram):
                    cum, pairs = 0, []
                    for edge, c in zip(child.edges, child.counts):
                        cum += c
                        pairs.append((edge, cum))
                    pairs.append((float("inf"), child.count))
                    value: Union[float, HistogramValue] = HistogramValue(
                        buckets=tuple(pairs), sum=child.sum,
                        count=child.count)
                else:
                    value = child.value
                samples.append((lbls, value))
            fams.append(FamilySnapshot(
                name=fam.name, kind=fam.kind, help=fam.help,
                labelnames=fam.labelnames, samples=tuple(samples)))
        return Snapshot(families=tuple(fams))
