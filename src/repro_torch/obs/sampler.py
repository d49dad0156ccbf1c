"""Per-iteration metrics sampling with provably bounded overhead.

``MetricsSampler`` binds one registry to one ``ServingEngine`` and is
invoked by the engine at the end of every ``step`` — the *existing* step
boundary, never a new one. Two rules keep the hot path intact:

  * **host-side values only.** Everything sampled is a Python int/float
    the engine already maintains (queue lengths, KVC block accounting,
    the ``n_*`` running counters). Device-resident values reach the
    registry exclusively through the lag-N readback ring the engine
    already drains — the ``engine_tokens_drained_total`` counter advances
    when the ring materializes tokens, never via a fresh ``device_get``;
  * **no control-flow influence.** The sampler reads, never writes,
    engine state, draws no RNG and dispatches nothing — so a metrics-on
    run is bitwise-identical to metrics-off with zero added blocking
    syncs (``hotpath_micro --check``'s ``bench_metrics`` gate).

Child handles are resolved once at ``attach`` and published by attribute
thereafter; ``sample_time`` accumulates the sampler's own wall-clock so
the overhead bound (< 5% of the decode loop) is measured, not assumed.
"""
from __future__ import annotations

import time
from typing import Optional

from .registry import MetricsRegistry

__all__ = ["MetricsSampler", "publish_engine", "SYNC_KINDS"]

SYNC_KINDS = ("eos_flags", "drain_blocking", "drain_backpressure",
              "drain_ready", "flush")


class MetricsSampler:
    """Zero-sync per-iteration sampler for one engine."""

    def __init__(self, registry: MetricsRegistry, instance: str = "0"):
        self.registry = registry
        self.instance = str(instance)
        self.sample_time = 0.0        # cumulative seconds spent sampling
        self.n_samples = 0
        ln = ("instance",)
        lv = {"instance": self.instance}
        r = registry
        # cached children: one dict lookup per family at attach, zero at
        # sample time
        self._g_pt = r.gauge(
            "scheduler_queue_depth", "requests waiting per queue",
            ("instance", "queue")).labels(queue="pt", **lv)
        self._g_gt = r.gauge(
            "scheduler_queue_depth", "requests waiting per queue",
            ("instance", "queue")).labels(queue="gt", **lv)
        self._g_running = r.gauge(
            "scheduler_running_requests", "decode-phase requests in the "
            "current groups", ln).labels(**lv)
        self._g_occ = r.gauge(
            "engine_kvc_occupied_blocks", "KVC blocks held by live "
            "allocations", ln).labels(**lv)
        self._g_free = r.gauge(
            "engine_kvc_free_blocks", "KVC blocks free", ln).labels(**lv)
        self._g_frac = r.gauge(
            "engine_kvc_allocated_frac", "allocated / total blocks",
            ln).labels(**lv)
        self._g_used = r.gauge(
            "engine_kvc_used_tokens", "tokens actually written into the "
            "cache", ln).labels(**lv)
        self._g_slots = r.gauge(
            "engine_free_slots", "free batch slots", ln).labels(**lv)
        self._g_ring = r.gauge(
            "engine_drain_ring_depth", "undrained readback-ring entries",
            ln).labels(**lv)
        self._g_mega = r.gauge(
            "engine_megastep_rows_left", "precomputed megastep rows not "
            "yet replayed", ln).labels(**lv)
        self._g_amort = r.gauge(
            "megastep_dispatch_amortization", "decode iterations per "
            "device dispatch", ln).labels(**lv)
        self._c_iters = r.counter(
            "engine_decode_iters_total", "decode iterations",
            ln).labels(**lv)
        self._c_disp = r.counter(
            "engine_decode_dispatches_total", "device decode dispatches",
            ln).labels(**lv)
        self._c_drained = r.counter(
            "engine_tokens_drained_total", "sampled tokens materialized "
            "through the readback ring", ln).labels(**lv)
        self._c_sync = {k: r.counter(
            "engine_host_syncs_total", "host sync events by kind",
            ("instance", "kind")).labels(kind=k, **lv)
            for k in SYNC_KINDS}
        self._c_blocking = r.counter(
            "engine_blocking_syncs_total", "pipeline-serializing host "
            "syncs (eos_flags + drain_blocking)", ln).labels(**lv)
        self._c_samples = r.counter(
            "sampler_samples_total", "sampler invocations",
            ln).labels(**lv)

    # ------------------------------------------------------------------ #
    def attach(self, engine) -> "MetricsSampler":
        """Register with the engine; ``engine.step`` calls ``on_step``
        from then on."""
        engine.metrics = self
        self.on_step(engine, 0.0)
        return self

    def on_step(self, engine, now: float) -> None:
        t0 = time.perf_counter()
        sched = engine.scheduler
        kvc = sched.kvc
        self._g_pt.set(len(sched.pt_queue))
        self._g_gt.set(len(sched.gt_queue))
        self._g_running.set(sum(len(g.members)
                                for g in sched.running_groups))
        self._g_occ.set(kvc.allocated_blocks)
        self._g_free.set(kvc.free_blocks)
        self._g_frac.set(kvc.allocated_frac)
        self._g_used.set(kvc.used_tokens)
        self._g_slots.set(len(engine.free_slots))
        self._g_ring.set(len(engine._pending_drain))
        self._g_mega.set(engine._mega_left)
        self._c_iters.inc_to(engine.decode_iters)
        self._c_disp.inc_to(engine.n_decode_dispatches)
        self._g_amort.set(engine.decode_iters
                          / max(1, engine.n_decode_dispatches))
        self._c_drained.inc_to(engine.n_tokens_drained)
        sc = engine.sync_counts
        for k, child in self._c_sync.items():
            child.inc_to(sc[k])
        self._c_blocking.inc_to(engine.n_blocking_syncs)
        self._c_samples.inc(1)
        self.n_samples += 1
        self.sample_time += time.perf_counter() - t0


def publish_engine(engine, reg: MetricsRegistry,
                   instance: str = "0") -> None:
    """Full one-shot publication of an engine's counters and gauges —
    the per-iteration sample plus every slow-moving counter. This is the
    single code path behind ``ServingEngine.debug_state`` and the
    ``--metrics`` exit dumps, so stall diagnostics and live metrics can
    never disagree."""
    MetricsSampler(reg, instance).on_step(engine, 0.0)
    lv = {"instance": str(instance)}
    ln = ("instance",)

    def c(name, help, value, **extra):
        fam = reg.counter(name, help, ln + tuple(sorted(extra)))
        fam.labels(**lv, **extra).inc_to(value)

    def g(name, help, value):
        reg.gauge(name, help, ln).labels(**lv).set(value)

    c("engine_prefill_waves_total", "whole-prompt prefill dispatch waves",
      engine.n_prefill_waves)
    c("engine_prefill_chunks_total", "chunked-prefill chunks executed",
      engine.n_prefill_chunks)
    c("engine_prefill_chunk_calls_total", "chunk-prefill dispatches",
      engine.n_chunk_calls)
    c("engine_prefill_compiles_total", "distinct prefill trace shapes",
      engine.n_prefill_compiles)
    c("engine_kv_migrations_total", "KV page images by direction",
      engine.n_kv_exports, direction="export")
    c("engine_kv_migrations_total", "KV page images by direction",
      engine.n_kv_injects, direction="inject")
    c("engine_kv_rejects_total", "corrupt KV images refused at inject",
      engine.n_kv_rejects)
    c("engine_aborted_total", "requests terminally aborted",
      engine.n_aborted)
    c("engine_shed_total", "rung-4 terminal sheds", engine.n_shed)
    c("engine_dup_deliveries_total", "duplicate deliveries suppressed",
      engine.n_dup_deliveries)
    c("engine_dup_completions_total", "duplicate terminal writes "
      "suppressed", engine.n_dup_completions)
    c("engine_swap_events_total", "host-swap ledger events",
      engine.n_swap_captures, kind="capture")
    c("engine_swap_events_total", "host-swap ledger events",
      engine.n_swap_restores, kind="restore")
    c("engine_swap_events_total", "host-swap ledger events",
      engine.n_swap_rejects, kind="reject")
    c("engine_swap_events_total", "host-swap ledger events",
      engine.n_swap_drops, kind="drop")
    g("engine_host_swap_images", "KV images parked in the host-swap "
      "ledger", len(engine._host_swap))
    g("engine_buffered_arrivals", "requests submitted but not yet due",
      len(engine._arrivals))
    g("engine_pending_injects", "KV injects awaiting a window boundary",
      len(engine._pending_injects))
    g("engine_pending_aborts", "aborts awaiting a window boundary",
      len(engine._pending_aborts))
    engine.scheduler.publish_metrics(reg, **lv)
