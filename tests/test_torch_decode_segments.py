"""The decode iteration cut into pieces at its paged-decode calls
(``model.decode_pieces``) and run through the decode graphs' static
buffers (``serving/decode_graphs.py``), held bit for bit against the
decode step written as one function and against ``model.decode_step``
in the engine, in float32 on the CPU. On the CPU ``DecodeGraphs``
captures nothing: each piece is a plain call, through the same static
buffers, in-place slot state and once-an-iteration context lengths as the
card's replays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.config import ATTN  # noqa: E402
from repro_torch.serving import (EngineConfig, GenRequest,  # noqa: E402
                                 SamplingParams, ServingEngine)
from repro_torch.serving.decode_graphs import DecodeGraphs  # noqa: E402
from repro_torch.serving.engine import advance  # noqa: E402
from test_torch_train_model import one_torch_thread  # noqa: E402,F401

F32 = dict(dtype="float32", param_dtype="float32")
B = 16


def _one_function(cfg, params, tokens, pos, caches, active):
    """The decode step as one function, each attention layer's call inline
    between its K/V writes and the restore of the inactive rows' slots:
    the form ``decode_pieces`` was cut from."""
    def attn_block(p, cfg, x, ck, cv, kv_heads):
        h = rms_norm(x, p[model.ATTN_NORM], cfg.rms_eps)
        C = ck.shape[1]
        q, k, v = attention._project_qkv(p, cfg, h, pos[:, None],
                                         kv_heads or cfg.num_kv_heads)
        ring = cfg.sliding_window is not None and C == cfg.sliding_window
        slot = (pos % C if ring else torch.clamp(pos, max=C - 1)).long()
        b = torch.arange(B)
        k_new, v_new = k[:, 0], v[:, 0]
        old_k, old_v = ck[b, slot], cv[b, slot]
        ck[b, slot] = k_new
        cv[b, slot] = v_new
        n = torch.clamp(pos + 1, max=C) if ring else pos + 1
        out = ops.decode_attention(q[:, 0], ck, cv, n,
                                   softcap=cfg.attn_logit_softcap)[:, None]
        m = active[:, None, None]
        ck[b, slot] = torch.where(m, k_new, old_k)
        cv[b, slot] = torch.where(m, v_new, old_v)
        x = x + attention.merge_heads(out) @ p["wo"]
        y, _ = model._ffn(p, cfg, rms_norm(x, p[model.MLP_NORM],
                                           cfg.rms_eps))
        return x + y

    x = model.embed(cfg, params, tokens)
    for kind, i, p, inv in model._walk(cfg, params):
        if kind == ATTN:
            x = attn_block(p, cfg, x, caches[ATTN]["k"][i],
                           caches[ATTN]["v"][i], None)
        else:
            state = model._index(caches[kind], i)
            y, new = model.RECURRENT_DECODE[kind](
                p, cfg, rms_norm(x, p["norm"], cfg.rms_eps), state)
            x = x + y
            model._write_state(state, new, active)
        if inv is not None:
            scfg = model._shared_cfg(cfg)
            x = attn_block(model.shared_params(params, cfg), scfg, x,
                           caches[model.SHARED]["k"][inv],
                           caches[model.SHARED]["v"][inv], scfg.num_kv_heads)
    return model.logits_fn(cfg, params, x[:, 0])


def _copy(caches):
    return {k: {n: t.clone() for n, t in sub.items()}
            for k, sub in caches.items()}


@pytest.mark.parametrize("arch,over,cap", [
    ("mistral_nemo_12b", dict(sliding_window=64), 64),
    ("phi3_5_moe_42b", dict(capacity_factor=0.5), 40),
    ("zamba2_7b", {}, 40),
    ("xlstm_125m", {}, 40),
], ids=["nemo-ring", "phi3.5-moe-drops", "zamba2", "xlstm"])
def test_pieces_equal_the_decode_step(arch, over, cap):
    """``decode_step`` (the pieces run with eager calls), the step written
    as one function, and one iteration of ``DecodeGraphs`` give the same
    logits, tokens, cache and state leaves, bit for bit, with about half
    the rows inactive: a ring of mistral-nemo's window written past its
    wrap, a phi3.5-MoE whose experts' capacity binds (16 rows at capacity
    factor 0.5), zamba2's Mamba2 layers around its shared attention, and
    an xLSTM stack, which has no call (one piece)."""
    cfg = get_config(arch).reduced().with_(**F32, **over)
    params = model.init(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(11)
    caches = model.init_cache(cfg, B, cap, device="cpu")
    for sub in caches.values():
        for n, t in sub.items():
            sub[n] = torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    pos = rng.integers(8, 2 * cap, B).astype(np.int32)
    if cfg.sliding_window is None:
        pos = np.minimum(pos, cap - 1)
    pos = torch.from_numpy(pos)
    active = torch.from_numpy(rng.random(B) < 0.5)
    active[:2] = torch.tensor([True, False])

    want_c = _copy(caches)
    want = _one_function(cfg, params, toks, pos, want_c, active)
    got_c = _copy(caches)
    got, _ = model.decode_step(cfg, params, toks, pos, got_c, active=active)
    assert torch.equal(got, want)

    def state():
        return {"last_tok": toks[:, 0].to(torch.int32).clone(),
                "pos": pos.clone(), "temps": torch.zeros(B),
                "top_ks": torch.zeros(B, dtype=torch.int32),
                "eos": torch.full((B,), -1, dtype=torch.int32),
                "active": active.clone()}
    st = state()
    new, eos = advance(st, torch.Generator(), got, active, False, False)
    g_st, g_c = state(), _copy(caches)
    graphs = DecodeGraphs(cfg, g_st, torch.Generator(), advance)
    g_new, g_eos = graphs.run(params, g_c, False, False, capture=False)
    assert torch.equal(g_new, new) and torch.equal(g_eos, eos)
    for n in st:
        assert torch.equal(g_st[n], st[n]), n
    for c in (got_c, g_c):
        for kind, sub in want_c.items():
            for n, t in sub.items():
                assert torch.equal(c[kind][n], t), (kind, n)
    if ATTN in caches or model.SHARED in caches:
        kind = ATTN if ATTN in caches else model.SHARED
        for n in ("k", "v"):
            assert torch.equal(got_c[kind][n][:, ~active],
                               caches[kind][n][:, ~active])
            assert not torch.equal(got_c[kind][n], caches[kind][n])


OVER = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab_size=256, **F32)


def _serve(graphs: bool, eos: int, sampled: bool):
    """A 1-layer qwen3 engine at megastep K = 8, readback lag 2, over 12
    requests with an EOS token (every third at temperature 1.3, top-k 4,
    when ``sampled``), on a KVC that preempts, its async iterations run
    through the decode graphs' program, as every unsharded engine's, or
    (``_decode_graphs`` cleared) through ``model.decode_step``, as a
    sharded engine's."""
    cfg = get_config("qwen3_8b").reduced(layers=1).with_(**OVER)
    eng = ServingEngine(
        cfg, max_batch=8, capacity=256, rl_accuracy=1.0, seed=0,
        scheduler_cfg=SchedulerConfig(
            kvc_tokens=512, block_size=16, tfs=256, max_model_len=256,
            max_batch_reqs=8, reserve_frac=0.0, pad_ratio=0.0, bucket=16),
        engine_cfg=EngineConfig(decode_megastep=8, readback_lag=2),
        device="cpu")
    assert eng._decode_graphs is not None and not eng._graphed
    if not graphs:
        eng._decode_graphs = None
    cuts = []
    mega = eng._mega_fn

    def spy(active, k_iters, need_sample, need_topk, stop_on_eos):
        out = mega(active, k_iters, need_sample, need_topk, stop_on_eos)
        cuts.append(stop_on_eos and bool(
            out[1][:k_iters - 1, active].any()))
        return out

    eng._mega_fn = spy
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(12):
        temp = 1.3 if sampled and i % 3 == 0 else 0.0
        reqs.append(GenRequest(
            prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, 16)],
            params=SamplingParams(max_new_tokens=112, temperature=temp,
                                  top_k=4 if temp else 0, eos_token=eos)))
    eng.run(reqs)
    s = eng.scheduler
    eng.n_cut_windows = sum(cuts)
    return eng, ([(g.rid, tuple(g.output), g.t_done) for g in reqs],
                 dict(eng.sync_counts), eng.decode_iters,
                 eng.n_decode_dispatches, eng.n_mega_windows,
                 tuple((r.rid, r.t_complete, r.generated, r.n_preemptions)
                       for r in s.completed))


# the first greedy stream's token at 70% of its length, of either
# workload: EOS cuts windows while requests wait
@pytest.mark.parametrize("eos,sampled", [(103, False), (255, True)],
                         ids=["greedy", "sampled"])
def test_engine_static_path_equals_the_eager_path(eos, sampled):
    """The engine through ``DecodeGraphs`` serves what it serves through
    ``model.decode_step``: streams, completion times, ``sync_counts``,
    decode iterations and dispatches, windows, the scheduler's decisions,
    and the sampling generator's final state; off the card nothing is
    captured or replayed."""
    stepped, want = _serve(False, eos, sampled)
    pieced, got = _serve(True, eos, sampled)
    assert got == want
    assert stepped.n_cut_windows > 0 and pieced.n_cut_windows > 0
    assert any(len(out) < 112 for _, out, _ in got[0])
    assert torch.equal(pieced.gen.get_state(), stepped.gen.get_state())
    assert pieced.decode_iters > 0
    assert pieced.n_graphed_decode_iters == stepped.n_graphed_decode_iters \
        == pieced.n_decode_captures == 0
