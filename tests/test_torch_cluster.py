"""The port's ``EngineFleet`` held against ``repro.cluster.EngineFleet`` on
the same weights (``params_from_jax``) and the same requests, in float32:
a unified fleet's conservation, prefill -> decode KV migration with and
without images, and the engine-level export/inject round trip (the
scenarios of ``tests/test_cluster.py``). Greedy streams, completion times,
terminal states, routes, migration counters and each engine's
``sync_counts`` must be equal.

``Backend`` and ``fleet_summary`` are shared with the fault, detector and
hedge parity tests (``test_torch_cluster_faults.py``,
``test_torch_cluster_detect.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.cluster as jcluster  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.scheduler import (  # noqa: E402
    SchedulerConfig as JSchedulerConfig)
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

SMALL = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             d_ff=256, vocab_size=256, dtype="float32",
             param_dtype="float32")

FLEET_COUNTERS = ("n_migrations", "n_kv_fallbacks", "n_recovered",
                  "n_failed_recoveries", "n_evacuations", "n_shed",
                  "n_deadline_aborts", "n_shed_reroutes", "n_shed_rescued",
                  "n_salvaged_restores", "n_fenced_completions",
                  "n_stale_drops", "double_routes")
ENGINE_COUNTERS = ("decode_iters", "n_decode_dispatches", "n_prefill_waves",
                   "n_prefill_chunks", "n_kv_exports", "n_kv_injects",
                   "n_kv_rejects", "n_dup_deliveries", "n_dup_completions",
                   "n_aborted", "n_shed", "n_swap_captures",
                   "n_swap_restores", "n_swap_rejects", "n_swap_drops")


class Backend:
    """One side of a parity test: the reference (``repro``) or the port
    (``repro_torch`` on the CPU, given the reference's weights). Scenarios
    build everything through it, so the same code drives both."""

    def __init__(self, port: bool):
        self.port = port
        self.cluster = tcluster if port else jcluster
        self.serving = tserving if port else jserving
        name = "qwen3_8b"
        self.cfg = (get_config(name) if port else jax_config(name)
                    ).reduced(layers=1).with_(**SMALL)
        self.SchedulerConfig = SchedulerConfig if port else JSchedulerConfig
        self._params = {}

    def __getattr__(self, name):
        for mod in (self.serving, self.cluster):
            if hasattr(mod, name):
                return getattr(mod, name)
        raise AttributeError(name)

    def params(self, seed: int):
        """The port's copy of the weights the reference draws from
        ``PRNGKey(seed)`` (what its fleet and engines build by default)."""
        if seed not in self._params:
            jcfg = jax_config("qwen3_8b").reduced(layers=1).with_(**SMALL)
            flat = jmodel.init(jcfg, jax.random.PRNGKey(seed))
            self._params[seed] = params_from_jax(
                {k: np.asarray(v) for k, v in flat.items()}, device="cpu",
                dtype=torch.float32)
        return self._params[seed]

    def fleet(self, n_instances=2, seed=0, **kw):
        if self.port:
            kw.setdefault("params", self.params(seed))
            kw["device"] = "cpu"
        return self.cluster.EngineFleet(self.cfg, n_instances=n_instances,
                                        seed=seed, **kw)

    def engine(self, seed=0, params=None, **kw):
        if self.port:
            kw["device"] = "cpu"
            if params is None:
                params = self.params(seed)
        return self.serving.ServingEngine(self.cfg, params=params,
                                          seed=seed, **kw)

    def reqs(self, n=6, seed=5, lo=4, hi=10):
        rng = np.random.default_rng(seed)
        return [self.GenRequest(
            prompt=[int(t) for t in rng.integers(
                0, self.cfg.vocab_size, int(rng.integers(8, 24)))],
            params=self.SamplingParams(
                max_new_tokens=int(rng.integers(lo, hi)), temperature=0.0))
            for _ in range(n)]


@pytest.fixture(scope="module")
def backends():
    return Backend(port=False), Backend(port=True)


def engine_summary(eng) -> dict:
    out = {k: getattr(eng, k) for k in ENGINE_COUNTERS}
    out["sync_counts"] = dict(eng.sync_counts)
    return out


def request_summary(reqs) -> dict:
    return {"streams": [list(g.output) for g in reqs],
            "t_done": [g.t_done for g in reqs],
            "status": [(g.status, g.fail_reason) for g in reqs]}


def fleet_summary(fleet, reqs) -> dict:
    """Everything a parity test compares, as plain Python values."""
    out = request_summary(reqs)
    out["route"] = [fleet.route_of.get(id(g)) for g in reqs]
    out["conservation"] = fleet.conservation()
    out["counters"] = {k: getattr(fleet, k) for k in FLEET_COUNTERS}
    out["instances"] = [(i.id, i.role, i.health, i.alive, i.crashed)
                        for i in fleet.instances]
    out["engines"] = [engine_summary(i.engine) for i in fleet.instances]
    if fleet.faults is not None:
        out["faults"] = list(fleet.faults.log)
    if fleet.detector is not None:
        out["transitions"] = list(fleet.detector.transitions)
        tr = fleet.transport
        out["transport"] = (tr.n_dropped, tr.n_duplicated, tr.n_delayed,
                            tr.n_retransmits)
    if fleet.hedge is not None:
        out["hedge"] = fleet.hedge.counters()
    return out


def assert_parity(scenario, backends):
    """Run ``scenario(B) -> summary`` on both sides; the summaries must be
    equal. Returns the port's summary."""
    jb, tb = backends
    want = scenario(jb)
    got = scenario(tb)
    for key in want:
        assert got[key] == want[key], f"{key}: port {got[key]} != " \
                                      f"reference {want[key]}"
    assert set(got) == set(want)
    return got


# --------------------------------------------------------------------- #
def _unified(B):
    fleet = B.fleet(2, router="least-kvc", max_batch=4, capacity=256,
                    rl_accuracy=1.0)
    reqs = fleet.run(B.reqs(n=8))
    return fleet_summary(fleet, reqs)


def test_fleet_conservation_unified_matches_jax(backends):
    s = assert_parity(_unified, backends)
    assert s["conservation"]["ok"]
    assert all(t is not None for t in s["t_done"])
    assert min(e["decode_iters"] for e in s["engines"]) > 0


def _disagg(kv_migration, router):
    def run(B):
        fleet = B.fleet(2, roles=("prefill", "decode"), router=router,
                        kv_migration=kv_migration, max_batch=4,
                        capacity=256, rl_accuracy=1.0)
        ref = B.engine(params=fleet.params, max_batch=4, capacity=256,
                       rl_accuracy=1.0)
        ref_reqs = B.reqs()
        ref.run(ref_reqs)
        out = fleet_summary(fleet, fleet.run(B.reqs()))
        out["ref_streams"] = [list(g.output) for g in ref_reqs]
        return out
    return run


@pytest.mark.parametrize("kv_migration,router", [
    (True, "least-kvc"), (False, "round-robin")],
    ids=["kv-image", "recompute-fallback"])
def test_fleet_kv_migration_matches_jax(backends, kv_migration, router):
    """Prefill -> decode migration: with KV images the receiver decodes
    from the injected pages; without, it re-prefills. Both equal the
    reference fleet and a single engine's greedy streams."""
    s = assert_parity(_disagg(kv_migration, router), backends)
    assert s["streams"] == s["ref_streams"]
    c = s["counters"]
    assert s["conservation"]["ok"] and c["n_migrations"] == 6
    assert c["n_kv_fallbacks"] == (0 if kv_migration else 6)


def _roundtrip(B):
    src = B.engine(max_batch=4, capacity=256, rl_accuracy=1.0)
    dst = B.engine(params=src.params, max_batch=4, capacity=256,
                   rl_accuracy=1.0, seed=1)
    g = B.reqs(n=1)[0]
    t = 0.0
    src.submit(g, t)
    while not src.scheduler.gt_queue:
        t += 1.0
        src.step(t)
    rid = next(iter(src.scheduler.gt_queue)).rid
    payload = src.export_kv(rid)
    assert not src.has_work()
    assert rid not in src.slot_of and rid not in src.scheduler.kvc.allocs
    new_rid = dst.inject_kv(payload, t)
    assert new_rid in dst.slot_of
    while dst.has_work() and t < 200:
        t += 1.0
        dst.step(t)
    out = request_summary([g])
    out["payload"] = {k: payload[k] for k in ("ctx", "last_tok")}
    out["image"] = {n: np.asarray(payload["kv"]["A"][n], np.float32)
                    for n in ("k", "v")}
    out["engines"] = [engine_summary(src), engine_summary(dst)]
    return out


def test_export_inject_roundtrip_matches_jax(backends):
    """Export removes the request from the source engine; inject seats
    the image in a slot of the target, which finishes the request. The
    image equals the reference's to float32 rounding."""
    jb, tb = backends
    want, got = _roundtrip(jb), _roundtrip(tb)
    for n in ("k", "v"):
        np.testing.assert_allclose(got["image"].pop(n),
                                   want["image"].pop(n),
                                   rtol=1e-5, atol=1e-5)
    assert got == want
    assert got["payload"]["ctx"] > 0
    assert got["status"] == [("completed", None)]


def test_export_image_is_a_copy_with_its_crc(backends):
    """On a CPU cache the exported image must not alias the slot's row:
    the next tenant's writes leave it, and its CRC, intact."""
    _, B = backends
    src = B.engine(max_batch=1, capacity=256, rl_accuracy=1.0)
    g, other = B.reqs(n=2)
    t = 0.0
    src.submit(g, t)
    while not src.scheduler.gt_queue:
        t += 1.0
        src.step(t)
    payload = src.export_kv(g.rid)
    src.run([other])
    assert tserving.engine.kv_checksum(payload["kv"]) == payload["kv_crc"]
    assert payload["kv"]["A"]["k"].data_ptr() != \
        src.caches["A"]["k"].data_ptr()
