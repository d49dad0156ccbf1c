"""The port's metrics plane (``repro_torch.obs``, a copy of the
reference's) on the port's engine and fleet, held against the reference on
the same weights and requests: after the same run, ``publish_metrics``
snapshots and ``debug_state`` are equal; a ``MetricsSampler`` changes no
token and no ``sync_counts`` entry; and every engine attribute the
publication reads is a host value, never a tensor (reading a CUDA tensor
would add a blocking sync).

One family is compared by neither side: ``engine_prefill_compiles_total``
counts the reference's XLA programs (power-of-two padded shapes) and the
port's distinct exact shapes, which eager execution runs unpadded."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.obs import MetricsSampler as JMetricsSampler  # noqa: E402
from repro_torch.obs import (MetricsRegistry, MetricsSampler,  # noqa: E402
                             publish_engine)
from test_torch_cluster import backends  # noqa: E402,F401


def _comparable(flat: dict) -> dict:
    return {k: v for k, v in flat.items()
            if not k.startswith("engine_prefill_compiles_total")}


def _stream(B, sampler=None, n=8):
    """One engine serving an online stream (an arrival every half
    iteration), with megastep windows opening and closing."""
    eng = B.engine(max_batch=4, capacity=128, rl_accuracy=1.0)
    if sampler is not None:
        sampler.attach(eng)
    rng = np.random.default_rng(3)
    reqs = [B.GenRequest(
        prompt=[int(t) for t in rng.integers(0, B.cfg.vocab_size, 12)],
        params=B.SamplingParams(max_new_tokens=int(rng.integers(4, 24)),
                                temperature=0.0))
        for _ in range(n)]
    eng.run(reqs, arrivals=[0.5 * i for i in range(n)])
    return eng, [list(g.output) for g in reqs]


def _registry(B):
    return MetricsRegistry() if B.port else JMetricsRegistry()


def _sampler(B, reg):
    return (MetricsSampler if B.port else JMetricsSampler)(reg, "0")


def test_publish_metrics_and_debug_state_match_jax(backends):  # noqa: F811
    snaps, dbgs, outs = [], [], []
    for B in backends:
        eng, out = _stream(B)
        reg = _registry(B)
        eng.publish_metrics(reg, instance="0")
        snaps.append(_comparable(reg.snapshot().flat()))
        dbgs.append(_comparable(eng.debug_state()))
        outs.append(out)
    assert outs[0] == outs[1]
    assert snaps[1] == snaps[0]
    assert dbgs[1] == dbgs[0] == snaps[0]
    assert snaps[1]['engine_decode_iters_total{instance="0"}'] > 0
    assert 'scheduler_completed_total{instance="0"}' in dbgs[1]


def test_sampler_changes_no_token_and_no_sync_count(backends):  # noqa: F811
    """The zero-sync contract: with a sampler attached the streams and
    every ``sync_counts`` entry equal the bare run's, on the port and on
    the reference, and the registry's totals mirror the engine's."""
    counts = []
    for B in backends:
        bare, off = _stream(B)
        reg = _registry(B)
        sampled, on = _stream(B, sampler=_sampler(B, reg))
        assert on == off
        assert sampled.sync_counts == bare.sync_counts
        snap = reg.snapshot()
        for kind, v in sampled.sync_counts.items():
            assert snap.get("engine_host_syncs_total", instance="0",
                            kind=kind) == v
        assert snap.get("engine_tokens_drained_total", instance="0") \
            == sampled.n_tokens_drained > 0
        counts.append((dict(sampled.sync_counts), _comparable(snap.flat())))
    assert counts[1] == counts[0]


class _Recorder:
    """Forwards attribute reads to an engine and records each value."""

    def __init__(self, eng):
        object.__setattr__(self, "_eng", eng)
        object.__setattr__(self, "reads", {})

    def __getattr__(self, name):
        v = getattr(self._eng, name)
        self.reads[name] = v
        return v


def test_publication_reads_only_host_values(backends):  # noqa: F811
    """Every engine attribute ``publish_engine`` reads, and every value
    under it, is a Python or numpy host value: the sampler adds no device
    read on the card."""
    _, B = backends
    eng, _ = _stream(B)
    rec = _Recorder(eng)
    publish_engine(rec, MetricsRegistry(), "0")
    assert {"scheduler", "free_slots", "_pending_drain", "_mega_left",
            "decode_iters", "sync_counts", "_host_swap"} <= set(rec.reads)

    def host(v, depth=0):
        assert not isinstance(v, torch.Tensor), v
        if depth < 2 and isinstance(v, dict):
            for x in v.values():
                host(x, depth + 1)
    for name, v in rec.reads.items():
        if name != "scheduler":
            host(v)


def _chaos_fleet(B, sampled):
    fleet = B.fleet(3, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0,
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=6.0, kind="kill", target=1)]),
                    recovery=B.RecoveryConfig(max_retries=3,
                                              backoff_base=1.0))
    reg = _registry(B)
    if sampled:
        fleet.attach_metrics(reg)
    reqs = fleet.run(B.reqs(n=8, lo=6, hi=14))
    fleet.publish_metrics(reg)
    return fleet, [list(g.output) for g in reqs], \
        _comparable(reg.snapshot().flat())


def test_fleet_metrics_under_chaos_match_jax(backends):  # noqa: F811
    """A killed instance, samplers on every engine: the fleet's snapshot
    and ``debug_state`` equal the reference's, and the samplers leave the
    port's streams and sync counts as a sampler-free run has them."""
    jb, tb = backends
    jfleet, jout, jsnap = _chaos_fleet(jb, sampled=True)
    fleet, out, snap = _chaos_fleet(tb, sampled=True)
    assert out == jout
    assert snap == jsnap
    assert _comparable(fleet.debug_state()) == \
        _comparable(jfleet.debug_state())
    bare, bare_out, _ = _chaos_fleet(tb, sampled=False)
    assert out == bare_out
    assert [i.engine.sync_counts for i in fleet.instances] == \
        [i.engine.sync_counts for i in bare.instances]
    assert snap['fleet_instance_health{instance="1"}'] == 2.0
