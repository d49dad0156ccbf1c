"""Production metrics plane: registry, zero-sync sampler, exporters, and
the serving loop's host spans.

    from repro_torch.obs import MetricsRegistry, MetricsSampler
    reg = MetricsRegistry()
    MetricsSampler(reg, instance="0").attach(engine)
    ...
    text = to_prometheus_text(reg.snapshot())

See ``ROADMAP.md`` (observability section) for the metric-naming
convention and the zero-overhead contract the ``hotpath_micro --check``
``bench_metrics`` gate enforces.

Host spans (``spans.py``): ``engine.spans = SpanTotals()`` adds up the
host nanoseconds and calls of each span of ``ServingEngine.step``:

    engine.admit                 buffered arrivals, injects and aborts
    scheduler.form_batch         the scheduler's plan
    engine.prefill_wave          whole prompts   } kernels.flash_call,
    engine.prefill_chunks        chunk grants    } model.moe inside
    engine.decode                the decode dispatch or window replay
      engine.drain               the readback ring's copy and appends
      engine.decode_launch       one iteration's or one window's launches
        kernels.decode_call      the paged decode wrapper, a layer
        model.moe
      engine.eos_readback        a blocking read of EOS flags
      engine.mega_replay         the host replay of a window's row
    scheduler.finish_iteration   bookkeeping and completions
    engine.drain                 the flushes of ``step``

Off (no totals, no profiler) a span costs one flag read. Under
``torch.profiler`` the four ranges ``engine.prefill_wave``,
``engine.prefill_chunks``, ``engine.decode`` and ``model.moe`` are
recorded, and no other span (``spans.PROFILER_RANGES``).
"""
from .exporters import (TimeSeriesLog, parse_prometheus_text,
                        to_prometheus_text, write_json_snapshot,
                        write_prometheus)
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       HistogramValue, MetricsRegistry, Snapshot)
from .sampler import SYNC_KINDS, MetricsSampler, publish_engine
from .spans import SpanTotals

__all__ = [
    "MetricsRegistry", "MetricsSampler", "Snapshot", "Counter", "Gauge",
    "Histogram", "HistogramValue", "DEFAULT_BUCKETS", "SYNC_KINDS",
    "publish_engine", "to_prometheus_text", "parse_prometheus_text",
    "write_prometheus", "write_json_snapshot", "TimeSeriesLog",
    "SpanTotals",
]
