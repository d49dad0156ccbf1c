"""The port's pressure ladder, aborts and KVC squeezes held against the JAX
engine on the same weights: host-swap capture and restore, budget-refused
captures, the proactive watermark guard, corrupt host images, an abort and
a squeeze mid-stream, and a squeeze deep enough to shed (the scenarios of
``tests/test_engine_swap.py``). Greedy streams, completion times, terminal
states, scheduler decisions and the engine's swap and sync counters must
be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.scheduler import (  # noqa: E402
    SchedulerConfig as JSchedulerConfig)
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import GenRequest as JGenRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import (EngineConfig, GenRequest,  # noqa: E402
                                 SamplingParams, ServingEngine)

SMALL = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
             d_ff=256, vocab_size=256, dtype="float32",
             param_dtype="float32")


@pytest.fixture(scope="module")
def cfgs():
    return (jax_config("qwen3_8b").reduced(layers=1).with_(**SMALL),
            get_config("qwen3_8b").reduced(layers=1).with_(**SMALL))


def _workload(G, S, vocab):
    rng = np.random.default_rng(3)
    return [G(prompt=[int(t) for t in rng.integers(
        0, vocab, int(rng.integers(12, 28)))],
        params=S(max_new_tokens=int(rng.integers(8, 20))))
        for _ in range(10)]


def _engines(cfgs, kvc_tokens, ecfg):
    jcfg, cfg = cfgs
    scfg = dict(kvc_tokens=kvc_tokens, block_size=16, tfs=128,
                max_model_len=128, max_batch_reqs=4)
    jeng = JServingEngine(jcfg, max_batch=4, capacity=128,
                          scheduler_cfg=JSchedulerConfig(**scfg),
                          rl_accuracy=0.5, seed=0,
                          engine_cfg=JEngineConfig(**ecfg))
    params = params_from_jax({k: np.asarray(v) for k, v in
                              jeng.params.items()}, device="cpu",
                             dtype=torch.float32)
    eng = ServingEngine(cfg, params, max_batch=4, capacity=128,
                        scheduler_cfg=SchedulerConfig(**scfg),
                        rl_accuracy=0.5, seed=0,
                        engine_cfg=EngineConfig(**ecfg), device="cpu")
    return jeng, eng


def _drive(eng, reqs, actions):
    """Submit everything at t=0, then step; ``actions[t]`` runs before
    step t (an abort or a squeeze, possibly inside a megastep window)."""
    for g in reqs:
        eng.submit(g, 0.0)
    t = 0.0
    while eng.has_work() and t < 2000:
        t += 1.0
        for op, arg in actions.get(int(t), ()):
            if op == "abort":
                eng.abort(arg, t, "test")
            else:
                eng.squeeze_kvc(arg)
        eng.step(t)
    eng.flush()


def _fingerprint(eng, reqs):
    s = eng.scheduler
    return ([(g.rid, tuple(g.output), g.t_done, g.status) for g in reqs],
            tuple((r.rid, r.t_complete, r.generated, r.n_preemptions)
                  for r in s.completed),
            s.n_preempt_free, s.n_preempt_swap, s.n_guard_swaps,
            dict(eng.sync_counts), eng.decode_iters,
            eng.n_decode_dispatches, eng.n_prefill_waves,
            eng.n_swap_captures, eng.n_swap_restores, eng.n_swap_drops,
            eng.n_swap_rejects, eng.n_aborted, eng.n_shed)


def _pair(cfgs, kvc_tokens, ecfg=None, actions=None):
    jeng, eng = _engines(cfgs, kvc_tokens, ecfg or {})
    vocab = cfgs[1].vocab_size
    jreqs = _workload(JGenRequest, JSamplingParams, vocab)
    reqs = _workload(GenRequest, SamplingParams, vocab)
    _drive(jeng, jreqs, actions or {})
    _drive(eng, reqs, actions or {})
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)
    eng.scheduler.kvc.check_invariants()
    assert not eng._host_swap and not eng.scheduler.kvc.swapped
    return eng, reqs


@pytest.mark.parametrize("ecfg,fired", [
    ({}, lambda e: e.n_swap_restores == e.n_swap_captures >= 1),
    ({"host_swap": False}, lambda e: e.n_swap_captures == 0
     and e.scheduler.n_preempt_swap >= 1),
    ({"host_pool_frac": 0.01}, lambda e: e.n_swap_drops >= 1
     and e.n_swap_restores == 0),
    ({"swap_watermarks": True, "guard_high": 0.6, "guard_low": 0.3,
      "guard_patience": 1}, lambda e: e.scheduler.n_guard_swaps >= 1
     and e.guard.n_trips >= 1 and e.n_swap_restores >= 1),
    ({"swap_watermarks": True, "guard_high": 0.6, "guard_low": 0.3,
      "guard_patience": 1, "decode_megastep": 1},
     lambda e: e.scheduler.n_guard_swaps >= 1),
], ids=["swap-restore", "swap-off", "tiny-pool", "guard", "guard-k1"])
def test_pressure_ladder_matches_jax(cfgs, ecfg, fired):
    kvc = 240 if ecfg.get("swap_watermarks") else 160
    eng, _ = _pair(cfgs, kvc, ecfg)
    assert fired(eng)


@pytest.mark.parametrize("actions,fired", [
    # an abort deferred by an open window, a deferred 40% squeeze, and an
    # abort applied at once
    ({6: [("abort", 2)], 9: [("squeeze", 0.4)], 14: [("abort", 7)]},
     lambda e: e.n_aborted == 2),
    # a squeeze so deep that queued requests no longer fit: rung-4 sheds
    ({4: [("squeeze", 0.85)]}, lambda e: e.n_shed >= 1),
], ids=["abort-squeeze", "squeeze-shed"])
def test_abort_and_squeeze_mid_stream_match_jax(cfgs, actions, fired):
    """Aborts and KVC squeezes part way through, under pressure: the same
    terminal states and decisions as the reference."""
    eng, reqs = _pair(cfgs, 240, actions=actions)
    assert fired(eng)
    assert sum(g.status == "aborted" for g in reqs) == eng.n_aborted
    assert sum(g.status == "shed" for g in reqs) == eng.n_shed
    assert all(g.finished for g in reqs)


def test_corrupt_host_image_degrades_to_recompute(cfgs):
    """A bit flipped in every captured host image is refused by the CRC
    check; recompute takes over and the streams stay those of the run with
    intact images."""
    _, cfg = cfgs
    _, good = _pair(cfgs, 160)
    _, eng = _engines(cfgs, 160, {})
    orig = eng._swap_out

    def corrupting(rid, slot):
        orig(rid, slot)
        img = eng._host_swap.get(rid)
        if img is not None:
            img["kv"]["A"]["k"].view(-1)[0] += 1.0
    eng._swap_out = corrupting
    reqs = _workload(GenRequest, SamplingParams, cfg.vocab_size)
    eng.run(reqs)
    assert eng.n_swap_captures >= 1
    assert eng.n_swap_rejects == eng.n_swap_captures
    assert eng.n_swap_restores == 0
    assert [g.output for g in reqs] == [g.output for g in good]
