"""Window transparency for the sampling generator: a megastep window that
EOS cuts short, or that runs on after its last sampling row's EOS, must
leave ``ServingEngine.gen`` where the K=1 path's single iterations leave
it, so that the sampled streams, completion times and scheduler decisions
of ``decode_megastep=8`` equal those of ``decode_megastep=1``, and so does
the generator's final state. The input is ``test_engine_pressure``'s
KVC-saturated workload (every third request at temperature 1.3, top-k 4)
with an EOS token that fires mid-window, on the reference's weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import (EngineConfig, GenRequest,  # noqa: E402
                                 SamplingParams, ServingEngine)
from test_torch_train_model import one_torch_thread  # noqa: E402,F401

OVER = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab_size=256, dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen3_8b").reduced(layers=1).with_(**OVER)
    cfg = get_config("qwen3_8b").reduced(layers=1).with_(**OVER)
    flat = jax_model.init(jcfg, jax.random.PRNGKey(0))
    return cfg, params_from_jax({k: np.asarray(v) for k, v in flat.items()},
                                device="cpu", dtype=torch.float32)


def _workload(cfg, eos):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(12):
        temp = 1.3 if i % 3 == 0 else 0.0
        reqs.append(GenRequest(
            prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, 16)],
            params=SamplingParams(max_new_tokens=112, temperature=temp,
                                  top_k=4 if temp else 0, eos_token=eos)))
    return reqs


def _run(cfg, params, K, eos):
    """Serve the workload; also return the windows the generator rule is
    about, by kind: ``cut``, EOS cut the window short while a row sampled;
    ``exit``, the window ran on after its last sampling row sampled its
    EOS (no waiter, so no cut), where the K=1 path stops drawing."""
    eng = ServingEngine(
        cfg, params, max_batch=8, capacity=256, rl_accuracy=1.0, seed=0,
        scheduler_cfg=SchedulerConfig(
            kvc_tokens=512, block_size=16, tfs=256, max_model_len=256,
            max_batch_reqs=8, reserve_frac=0.0, pad_ratio=0.0, bucket=16),
        engine_cfg=EngineConfig(decode_megastep=K), device="cpu")
    seen = {"cut": 0, "exit": 0}
    mega = eng._mega_fn

    def spy(active, k_iters, need_sample, need_topk, stop_on_eos):
        out = mega(active, k_iters, need_sample, need_topk, stop_on_eos)
        flags = out[1][:k_iters].numpy()
        if need_sample and stop_on_eos:
            seen["cut"] += bool(flags[:-1, active.numpy()].any())
        elif need_sample:
            hit = flags[:, active.numpy() & (eng.temps > 0)]
            exits = np.where(hit.any(axis=0), hit.argmax(axis=0) + 1,
                             k_iters)
            seen["exit"] += bool(exits.max() < k_iters)
        return out

    eng._mega_fn = spy
    reqs = _workload(cfg, eos)
    eng.run(reqs)
    per_req = [(g.rid, tuple(g.output), g.t_done) for g in reqs]
    s = eng.scheduler
    sched = (tuple(s.iter_completion_counts),
             tuple((r.rid, r.t_complete, r.generated, r.n_preemptions)
                   for r in s.completed),
             s.n_preempt_free, s.n_preempt_swap, s.n_underprov,
             s.n_hosted, s.n_reserve_rescues)
    return (per_req, sched), seen, eng


# the first greedy stream's tokens at 70%, 30% and 8% of its length
@pytest.mark.parametrize("eos,kind", [(247, "cut"), (181, "cut"),
                                      (153, "exit")])
def test_cut_window_leaves_the_generator_where_k1_does(model, eos, kind):
    cfg, params = model
    fp1, _, e1 = _run(cfg, params, 1, eos)
    fp8, seen, e8 = _run(cfg, params, 8, eos)
    assert seen[kind], f"no window of kind {kind!r}"
    assert any(len(out) < 112 for _, out, _ in fp8[0])
    assert e8.n_decode_dispatches < e8.decode_iters
    assert fp8 == fp1
    assert torch.equal(e8.gen.get_state(), e1.gen.get_state())
