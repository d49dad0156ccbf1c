"""The port's fleet under faults held against the reference fleet on the
same weights and requests, in float32: the scenarios of
``tests/test_cluster_faults.py`` (kill, retry exhaustion, freeze with
evacuation, corrupt KV, KVC squeezes, deadline aborts, admission shedding,
an inject into a full target). Streams, completion times, terminal states,
routes, the fleet's recovery and migration counters, fault logs and each
engine's ``sync_counts`` must be equal, and each scenario's own gate (the
greedy streams of a fault-free engine, the invariant audit) must hold on
the port.

Left out: ``test_fleet_kill_salvages_host_image_for_restore``, whose
reference test fails; it is not a parity target until it passes."""
import pytest

pytest.importorskip("torch")

from test_torch_cluster import (assert_parity, backends,  # noqa: E402,F401
                                fleet_summary, request_summary)


def _with_ref(B, fleet, reqs_kw, run_kw=None, **ref_kw):
    """Serve the scenario's requests on a fault-free engine sharing the
    fleet's weights, then on the fleet; returns the fleet's summary with
    the engine's streams and the invariant audit beside it."""
    ref_kw = dict(dict(max_batch=4, capacity=256, rl_accuracy=1.0),
                  **ref_kw)
    ref = B.engine(params=fleet.params, **ref_kw)
    ref_reqs = B.reqs(**reqs_kw)
    ref.run(ref_reqs)
    reqs = fleet.run(B.reqs(**reqs_kw), **(run_kw or {}))
    out = fleet_summary(fleet, reqs)
    out["ref_streams"] = [list(g.output) for g in ref_reqs]
    out["audit"] = B.check_fleet_invariants(fleet, strict=False)["ok"]
    return out


def _kill(B):
    fleet = B.fleet(3, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0,
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=6.0, kind="kill", target=1)]),
                    recovery=B.RecoveryConfig(max_retries=3,
                                              backoff_base=1.0))
    return _with_ref(B, fleet, dict(n=8, lo=6, hi=14))


def _retry_exhaustion(B):
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0,
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=4.0, kind="kill", target=0),
                        B.FaultEvent(t=4.0, kind="kill", target=1)]),
                    recovery=B.RecoveryConfig(max_retries=2,
                                              backoff_base=1.0))
    return fleet_summary(fleet, fleet.run(B.reqs(n=4, lo=8, hi=16)))


def _freeze_evacuate(B):
    fleet = B.fleet(2, router="round-robin", max_batch=4, capacity=256,
                    rl_accuracy=1.0, faults=B.FaultInjector(),
                    recovery=B.RecoveryConfig())
    ref = B.engine(params=fleet.params, max_batch=4, capacity=256,
                   rl_accuracy=1.0)
    g_ref = B.reqs(n=1, lo=8, hi=9)[0]
    ref.run([g_ref])
    g = B.reqs(n=1, lo=8, hi=9)[0]
    iid = fleet.submit(g, 0.0)
    src = next(i for i in fleet.instances if i.id == iid)
    t = 0.0
    while not src.engine.scheduler.gt_queue:     # stop right after prefill
        t += 1.0
        src.engine.step(t)
    src.health = "suspect"
    src.frozen_until = t + 1_000.0
    while fleet.has_work() and t < 300.0:
        t += 1.0
        fleet.step(t)
    out = fleet_summary(fleet, [g])
    out["ref_streams"] = [list(g_ref.output)]
    return out


def _corrupt_kv(B):
    fleet = B.fleet(2, roles=("prefill", "decode"), router="least-kvc",
                    max_batch=4, capacity=256, rl_accuracy=1.0,
                    faults=B.FaultInjector(schedule=[
                        B.FaultEvent(t=1.0, kind="corrupt_kv", count=2)]),
                    recovery=B.RecoveryConfig())
    return _with_ref(B, fleet, dict(n=6))


def _squeeze(frac):
    def run(B):
        scfg = B.SchedulerConfig(kvc_tokens=224, block_size=16, tfs=128,
                                 max_model_len=128, max_batch_reqs=4)
        fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=128,
                        rl_accuracy=1.0, scheduler_cfg=scfg,
                        faults=B.FaultInjector(schedule=[
                            B.FaultEvent(t=3.0, kind="squeeze", target=0,
                                         frac=frac),
                            B.FaultEvent(t=3.0, kind="squeeze", target=1,
                                         frac=frac)]),
                        recovery=B.RecoveryConfig(max_retries=3,
                                                  backoff_base=1.0))
        out = _with_ref(B, fleet, dict(n=10, lo=8, hi=16), capacity=128)
        out["pressure"] = sum(i.engine.scheduler.n_preempt_swap
                              + i.engine.scheduler.kvc.n_swap_outs
                              for i in fleet.instances)
        return out
    return run


def _deadline(B):
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0,
                    recovery=B.RecoveryConfig(deadline_factor=2.0))
    hopeless = B.GenRequest(
        prompt=list(range(10)),
        params=B.SamplingParams(max_new_tokens=400, temperature=0.0),
        deadline=3.0)
    reqs = [hopeless] + B.reqs(n=2)
    fleet.run(reqs)
    out = fleet_summary(fleet, reqs)
    out["audit"] = B.check_fleet_invariants(fleet, strict=False)["ok"]
    return out


def _shed(B):
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0, recovery=B.RecoveryConfig(shed=True))
    doomed = B.GenRequest(
        prompt=list(range(10)),
        params=B.SamplingParams(max_new_tokens=200, temperature=0.0),
        deadline=5.0)
    reqs = [doomed] + B.reqs(n=2)
    fleet.run(reqs)
    return fleet_summary(fleet, reqs)


def _full_target(B):
    """A migration onto an engine whose only slot is taken takes the
    slotless recompute fallback and still finishes with the exact
    stream."""
    src = B.engine(max_batch=4, capacity=256, rl_accuracy=1.0)
    dst = B.engine(params=src.params, max_batch=1, capacity=256,
                   rl_accuracy=1.0, seed=1)
    ref = B.engine(params=src.params, max_batch=4, capacity=256,
                   rl_accuracy=1.0, seed=2)
    g_ref = B.reqs(n=1, lo=6, hi=7)[0]
    ref.run([g_ref])
    hog = B.reqs(n=1, seed=9, lo=64, hi=65)[0]
    t = 0.0
    dst.submit(hog, t)
    while not dst.slot_of:
        t += 1.0
        dst.step(t)
    g = B.reqs(n=1, lo=6, hi=7)[0]
    src.submit(g, t)
    while not src.scheduler.gt_queue:
        t += 1.0
        src.step(t)
    payload = src.export_kv(g.rid)
    assert payload["kv"] is not None and not dst.free_slots
    dst.inject_kv(payload, t)
    while dst.has_work() and t < 800:
        t += 1.0
        dst.step(t)
    out = request_summary([g, hog])
    out["ref_streams"] = [list(g_ref.output)]
    out["slots"] = (sorted(dst.slot_of), len(dst.free_slots))
    out["sync_counts"] = [dict(src.sync_counts), dict(dst.sync_counts)]
    return out


def _gate_recovered(s):
    c = s["conservation"]
    assert c["ok"] and c["aborted"] == 0 and c["shed"] == 0, c
    assert s["counters"]["n_recovered"] >= 1
    assert s["instances"][1][3] is False            # instance 1 is dead
    assert s["streams"] == s["ref_streams"] and s["audit"]


def _gate_exhausted(s):
    assert s["conservation"]["ok"] and s["conservation"]["aborted"] >= 1
    assert all("retries-exhausted" in r or r == "no-live-instance"
               for st, r in s["status"] if st == "aborted")


def _gate_evacuated(s):
    assert s["counters"]["n_evacuations"] >= 1
    assert s["t_done"][0] is not None and s["streams"] == s["ref_streams"]
    assert s["conservation"]["ok"]


def _gate_rejected(s):
    assert s["conservation"]["ok"] and s["conservation"]["kv_rejects"] >= 1
    assert s["streams"] == s["ref_streams"]


def _gate_squeezed(s):
    c = s["conservation"]
    assert c["ok"] and c["aborted"] == 0 and c["shed"] == 0, c
    assert s["streams"] == s["ref_streams"] and s["audit"]
    assert s["pressure"] >= 1


def _gate_squeeze_shed(s):
    c = s["conservation"]
    assert c["ok"] and c["shed"] >= 1 and s["audit"]
    for (st, reason), out, ref in zip(s["status"], s["streams"],
                                      s["ref_streams"]):
        assert reason == "kvc-infeasible" if st == "shed" else out == ref


def _gate_deadline(s):
    assert s["status"][0] == ("aborted", "deadline")
    assert s["counters"]["n_deadline_aborts"] >= 1
    assert all(t is not None for t in s["t_done"][1:])
    assert s["conservation"]["aborted"] == 1 and s["audit"]


def _gate_shed(s):
    assert s["status"][0] == ("shed", "projected-slo-miss")
    assert all(t is not None for t in s["t_done"][1:])
    assert s["conservation"]["ok"] and s["conservation"]["shed"] == 1


def _gate_full_target(s):
    assert s["streams"][0] == s["ref_streams"][0]
    assert all(t is not None for t in s["t_done"])
    assert s["slots"] == ([], 1)


SCENARIOS = {
    "kill": (_kill, _gate_recovered),
    "retry-exhaustion": (_retry_exhaustion, _gate_exhausted),
    "freeze-evacuate": (_freeze_evacuate, _gate_evacuated),
    "corrupt-kv": (_corrupt_kv, _gate_rejected),
    "squeeze": (_squeeze(0.5), _gate_squeezed),
    "squeeze-shed": (_squeeze(0.6), _gate_squeeze_shed),
    "deadline": (_deadline, _gate_deadline),
    "shed": (_shed, _gate_shed),
    "inject-full-target": (_full_target, _gate_full_target),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_fault_scenario_matches_jax(backends, name):  # noqa: F811
    run, gate = SCENARIOS[name]
    gate(assert_parity(run, backends))
