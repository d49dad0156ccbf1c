"""The port's fleet on the detected-failure substrate held against the
reference fleet on the same weights and requests, in float32: the fleet
scenarios of ``tests/test_cluster_detector.py`` (detector on without
faults, dropped beats, a silent kill, the shed-retry tier) and of
``tests/test_cluster_hedge.py`` (hedging off, a hedge race under a
straggler and a partition). Streams, completion times, terminal states,
routes, detector transitions, transport and hedge counters and each
engine's ``sync_counts`` must be equal, and each scenario's own gate must
hold on the port."""
import pytest

pytest.importorskip("torch")

from test_torch_cluster import (assert_parity, backends,  # noqa: E402,F401
                                fleet_summary)
from test_torch_cluster_faults import _with_ref  # noqa: E402


def _detector_identity(B):
    plain = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0)
    p_reqs = plain.run(B.reqs(n=8, lo=6, hi=14))
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0, detector=B.DetectorConfig())
    out = fleet_summary(fleet, fleet.run(B.reqs(n=8, lo=6, hi=14)))
    out["ref_streams"] = [list(g.output) for g in p_reqs]
    out["ref_sync_counts"] = [dict(i.engine.sync_counts)
                              for i in plain.instances]
    out["audit"] = B.check_fleet_invariants(fleet, strict=False)["ok"]
    return out


def _dropped_beats(B):
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0, detector=B.DetectorConfig(),
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=2.0, kind="drop", target=1,
                                     duration=6.0, frac=1.0)]),
                    recovery=B.RecoveryConfig(max_retries=3,
                                              backoff_base=1.0))
    out = _with_ref(B, fleet, dict(n=8, lo=6, hi=14))
    out["reinstated"] = fleet.detector.n_reinstated
    return out


def _detected_kill(B):
    fleet = B.fleet(3, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0, detector=B.DetectorConfig(),
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=6.0, kind="kill", target=1)]),
                    recovery=B.RecoveryConfig(max_retries=3,
                                              backoff_base=1.0))
    return _with_ref(B, fleet, dict(n=8, lo=6, hi=14))


def _shed_retry(B):
    scfg = B.SchedulerConfig(kvc_tokens=224, block_size=16, tfs=128,
                             max_model_len=128, max_batch_reqs=4)
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=128,
                    rl_accuracy=1.0, scheduler_cfg=scfg,
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=3.0, kind="squeeze", target=0,
                                     frac=0.6)]),
                    recovery=B.RecoveryConfig(max_retries=4,
                                              backoff_base=1.0,
                                              shed_retry=True))
    return _with_ref(B, fleet, dict(n=10, lo=8, hi=16), capacity=128)


def _hedge_off(B):
    kw = dict(router="least-kvc", max_batch=4, capacity=256,
              rl_accuracy=1.0, detector=B.DetectorConfig())
    arrivals = dict(arrivals=[0.5 * i for i in range(8)])
    plain = B.fleet(2, **kw)
    p_reqs = plain.run(B.reqs(n=8, lo=6, hi=12), **arrivals)
    off = B.fleet(2, hedge=B.HedgeConfig(enabled=False), **kw)
    out = fleet_summary(off, off.run(B.reqs(n=8, lo=6, hi=12), **arrivals))
    out["ref_streams"] = [list(g.output) for g in p_reqs]
    return out


def _hedge_race(B):
    scfg = B.SchedulerConfig(kvc_tokens=224, block_size=16, tfs=128,
                             max_model_len=128, max_batch_reqs=4)
    spec = "slow@2:1/40x6,part@6:2|0/12"
    fleet = B.fleet(3, router="least-kvc", max_batch=4, capacity=128,
                    rl_accuracy=1.0, scheduler_cfg=scfg,
                    faults=B.FaultInjector(
                        schedule=B.parse_chaos_spec(spec, 3), seed=0,
                        min_alive=1),
                    recovery=B.RecoveryConfig(max_retries=4,
                                              backoff_base=1.0,
                                              shed_retry=True),
                    detector=B.DetectorConfig(), hedge=B.HedgeConfig())
    return _with_ref(B, fleet, dict(n=10, lo=8, hi=16), capacity=128,
                     scheduler_cfg=scfg)


def _gate_identity(s):
    assert s["streams"] == s["ref_streams"]
    assert s["transitions"] == [] and s["transport"][:3] == (0, 0, 0)
    assert [e["sync_counts"] for e in s["engines"]] == s["ref_sync_counts"]
    assert s["audit"] and s["conservation"]["dup_deliveries"] == 0


def _gate_reinstated(s):
    assert s["reinstated"] >= 1 and all(i[3] for i in s["instances"])
    assert s["streams"] == s["ref_streams"] and s["audit"]
    assert s["conservation"]["ok"] and s["conservation"]["aborted"] == 0


def _gate_detected_kill(s):
    assert [(a, b) for _, iid, a, b in s["transitions"] if iid == 1] == \
        [("healthy", "suspect"), ("suspect", "dead")]
    c = s["conservation"]
    assert c["ok"] and c["aborted"] == 0 and c["shed"] == 0, c
    assert s["streams"] == s["ref_streams"] and s["audit"]


def _gate_rescued(s):
    c = s["conservation"]
    assert c["ok"] and c["shed"] == 0 and c["aborted"] == 0, c
    assert s["counters"]["n_shed_reroutes"] >= 1
    assert s["counters"]["n_shed_rescued"] >= 1
    assert s["streams"] == s["ref_streams"] and s["audit"]


def _gate_hedge_off(s):
    assert s["streams"] == s["ref_streams"]
    assert sum(s["hedge"].values()) == 0


def _gate_hedge_race(s):
    c = s["conservation"]
    assert c["ok"] and c["dup_completions"] == 0
    assert s["hedge"]["hedges_fired"] >= 1 and s["hedge"]["hedges_won"] >= 1
    assert s["counters"]["n_fenced_completions"] >= 1
    assert all(out == ref for (st, _), out, ref in zip(
        s["status"], s["streams"], s["ref_streams"]) if st != "shed")
    assert s["audit"]


SCENARIOS = {
    "detector-identity": (_detector_identity, _gate_identity),
    "dropped-beats": (_dropped_beats, _gate_reinstated),
    "detected-kill": (_detected_kill, _gate_detected_kill),
    "shed-retry": (_shed_retry, _gate_rescued),
    "hedge-off": (_hedge_off, _gate_hedge_off),
    "hedge-race-partition": (_hedge_race, _gate_hedge_race),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_detect_scenario_matches_jax(backends, name):  # noqa: F811
    run, gate = SCENARIOS[name]
    gate(assert_parity(run, backends))
