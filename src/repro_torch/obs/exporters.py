"""Exporters for registry snapshots: Prometheus text format, JSON
time-series, and Chrome ``trace_event`` request-lifecycle spans.

All exporters consume the immutable :class:`~repro_torch.obs.registry.Snapshot`
(or the :class:`TimeSeriesLog` accumulated from snapshots) — nothing here
reads live subsystem state, so an export can never disagree with the
diagnostics built from the same snapshot.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .registry import HistogramValue, Snapshot, _render_labels

__all__ = ["to_prometheus_text", "parse_prometheus_text",
           "write_prometheus", "TimeSeriesLog", "write_json_snapshot",
           "request_trace_events", "write_chrome_trace"]


# --------------------------------------------------------------------- #
# Prometheus text exposition format
# --------------------------------------------------------------------- #
def to_prometheus_text(snap: Snapshot) -> str:
    """Render a snapshot in the Prometheus text exposition format
    (``# HELP`` / ``# TYPE`` headers, histogram ``_bucket``/``_sum``/
    ``_count`` expansion, cumulative ``le`` buckets ending at +Inf)."""
    lines: List[str] = []
    for fam in snap.families:
        if not fam.samples:
            continue
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for lbls, value in fam.samples:
            base = _render_labels(lbls)
            if isinstance(value, HistogramValue):
                for le, c in value.buckets:
                    lines.append(
                        f"{fam.name}_bucket{_render_labels(lbls, le=le)}"
                        f" {c}")
                lines.append(f"{fam.name}_sum{base} {_fmt(value.sum)}")
                lines.append(f"{fam.name}_count{base} {value.count}")
            else:
                lines.append(f"{fam.name}{base} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal exposition-format parser (sample name+labels -> value).
    Used by CI smokes to assert an export round-trips; raises ValueError
    on any malformed sample line."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{labels} value  |  name value
        head, _, tail = line.rpartition(" ")
        if not head:
            raise ValueError(f"malformed sample line: {line!r}")
        try:
            out[head] = float(tail)
        except ValueError:
            raise ValueError(f"malformed sample value: {line!r}")
        name = head.split("{", 1)[0]
        if not (name and name[0].isalpha() and all(
                c.isalnum() or c == "_" for c in name)):
            raise ValueError(f"malformed sample name: {line!r}")
    if not out:
        raise ValueError("no samples in exposition text")
    return out


def write_prometheus(snap: Snapshot, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus_text(snap))


# --------------------------------------------------------------------- #
# JSON time series
# --------------------------------------------------------------------- #
class TimeSeriesLog:
    """Append-only (t, value) series keyed by flat sample name.

    ``record`` takes explicit name->value pairs (the replayer's derived
    rates); ``record_snapshot`` pulls every scalar sample out of a
    registry snapshot. Export is one JSON document:
    ``{"series": {name: {"t": [...], "v": [...]}}}``.
    """

    def __init__(self):
        self.series: Dict[str, Tuple[List[float], List[float]]] = {}

    def _append(self, name: str, t: float, v: float) -> None:
        ts, vs = self.series.setdefault(name, ([], []))
        ts.append(float(t))
        vs.append(float(v))

    def record(self, t: float, values: Dict[str, float]) -> None:
        for name, v in values.items():
            self._append(name, t, v)

    def record_snapshot(self, t: float, snap: Snapshot,
                        names: Optional[Iterable[str]] = None) -> None:
        want = None if names is None else set(names)
        for name, v in snap.flat().items():
            base = name.split("{", 1)[0]
            if want is not None and base not in want:
                continue
            self._append(name, t, v)

    def to_json(self) -> dict:
        return {"series": {name: {"t": ts, "v": vs}
                           for name, (ts, vs) in self.series.items()}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def write_json_snapshot(snap: Snapshot, path: str,
                        extra: Optional[dict] = None) -> None:
    """One flat ``{sample-name: value}`` JSON snapshot (plus optional
    run-level metadata under ``"meta"``)."""
    doc = {"metrics": snap.flat()}
    if extra:
        doc["meta"] = extra
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


# --------------------------------------------------------------------- #
# Chrome trace_event request-lifecycle spans
# --------------------------------------------------------------------- #
# phase spans are reconstructed from the Request JCT decomposition the
# scheduler already maintains (§2.2 timestamps), so the trace agrees with
# the metrics by construction: queued (arrival -> first execution),
# prefill (first execution -> first token), decode (first token ->
# terminal), with swap/migrate time and preemptions attached as args.
def request_trace_events(requests: Sequence, pid: int = 0,
                         clock_us: float = 1e6) -> List[dict]:
    """Chrome ``trace_event`` list for a set of ``repro_torch.core.request``
    Requests. ``clock_us`` converts iteration-clock units to trace
    microseconds. One trace row (tid) per request."""
    events: List[dict] = []

    def span(name: str, rid: int, t0: float, t1: float, **args) -> None:
        if t1 < t0:
            return
        events.append({"name": name, "cat": "request", "ph": "X",
                       "pid": pid, "tid": rid,
                       "ts": t0 * clock_us,
                       "dur": max(0.0, (t1 - t0)) * clock_us,
                       "args": args})

    for r in requests:
        t_exec = r.t_start_exec
        t_first = r.t_first_token
        t_end = r.t_complete
        terminal = "completed" if t_end is not None else r.state.value
        if t_end is None:
            # aborted/shed: close open spans at the last charged event
            t_end = r._last_event_t
        span("queued", r.rid, r.arrival,
             t_exec if t_exec is not None else t_end,
             prompt_len=r.prompt_len)
        if t_exec is not None:
            span("prefill", r.rid, t_exec,
                 t_first if t_first is not None else t_end,
                 prompt_len=r.prompt_len)
        if t_first is not None:
            span("decode", r.rid, t_first, t_end,
                 generated=r.generated, terminal=terminal)
        if r.swap_time > 0 or r.n_preemptions > 0:
            # swap/migrate holds have no absolute timestamps in the JCT
            # decomposition — attach the totals as an instant marker
            events.append({"name": "swap_migrate", "cat": "request",
                           "ph": "i", "s": "t", "pid": pid, "tid": r.rid,
                           "ts": t_end * clock_us,
                           "args": {"swap_time": r.swap_time,
                                    "preempt_time": r.preempt_time,
                                    "n_preemptions": r.n_preemptions}})
        if terminal != "completed":
            events.append({"name": terminal, "cat": "request", "ph": "i",
                           "s": "t", "pid": pid, "tid": r.rid,
                           "ts": t_end * clock_us, "args": {}})
    return events


def write_chrome_trace(events: List[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
