"""Production metrics plane: registry, zero-sync sampler, exporters.

    from repro_torch.obs import MetricsRegistry, MetricsSampler
    reg = MetricsRegistry()
    MetricsSampler(reg, instance="0").attach(engine)
    ...
    text = to_prometheus_text(reg.snapshot())

See ``ROADMAP.md`` (observability section) for the metric-naming
convention and the zero-overhead contract the ``hotpath_micro --check``
``bench_metrics`` gate enforces.
"""
from .exporters import (TimeSeriesLog, parse_prometheus_text,
                        request_trace_events, to_prometheus_text,
                        write_chrome_trace, write_json_snapshot,
                        write_prometheus)
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       HistogramValue, MetricsRegistry, Snapshot)
from .sampler import SYNC_KINDS, MetricsSampler, publish_engine

__all__ = [
    "MetricsRegistry", "MetricsSampler", "Snapshot", "Counter", "Gauge",
    "Histogram", "HistogramValue", "DEFAULT_BUCKETS", "SYNC_KINDS",
    "publish_engine", "to_prometheus_text", "parse_prometheus_text",
    "write_prometheus", "write_json_snapshot", "TimeSeriesLog",
    "request_trace_events", "write_chrome_trace",
]
