"""The port's ``ServingEngine(device="cpu")`` held against
``repro.serving.ServingEngine`` on the same weights (``params_from_jax``)
and the same requests, in float32: greedy token streams, completion times,
scheduler decisions, ``sync_counts`` and the dispatch counters must be
equal. Sampled rows use different generators on the two sides (threefry
vs torch), so they are held to their length only, and the sampling support
is checked on its own. The reference runs with its default ``impl="xla"``,
which agrees with the kernels' float32 numerics."""
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
from repro_torch.kernels.ref import POS_INVALID  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import (EngineConfig, GenRequest,  # noqa: E402
                                 SamplingParams, ServingEngine)
from repro_torch.serving.engine import packed_chunk_layout  # noqa: E402
from repro_torch.serving.sampling import sample_in_graph  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
LEGACY = dict(async_decode=False, packed_prefill=False)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_config("qwen3_8b").reduced(d_model=128).with_(**F32),
            get_config("qwen3_8b").reduced(d_model=128).with_(**F32))


def _megastep_workload(G, S, vocab):
    """``test_engine_megastep._workload``: long outputs, so windows fuse."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(4):
        plen = int(rng.integers(4, 18))
        temp = 0.0 if i % 2 else 1.3
        reqs.append(G(prompt=[int(t) for t in rng.integers(0, vocab, plen)],
                      params=S(max_new_tokens=int(rng.integers(24, 40)),
                               temperature=temp, top_k=4 if temp else 0)))
    return reqs


def _async_workload(G, S, vocab):
    """``test_engine_async._workload``: mixed greedy / hot rows."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        plen = int(rng.integers(4, 18))
        temp = 0.0 if i % 3 else 1.3
        reqs.append(G(prompt=[int(t) for t in rng.integers(0, vocab, plen)],
                      params=S(max_new_tokens=int(rng.integers(3, 9)),
                               temperature=temp, top_k=0 if not temp else 4)))
    return reqs


def _preempt_workload(G, S, vocab):
    """``test_engine_async`` preemption scenario (always-wrong predictor)."""
    rng = np.random.default_rng(5)
    return [G(prompt=[int(t) for t in rng.integers(
        0, vocab, int(rng.integers(4, 18)))],
        params=S(max_new_tokens=int(rng.integers(12, 28))))
        for _ in range(6)]


def _chunk_workload(G, S, vocab):
    """Three prompts longer than TFS (32) plus short fillers: chunk waves
    of several requests, with a hot row in flight."""
    rng = np.random.default_rng(7)
    reqs = [G(prompt=[int(t) for t in rng.integers(0, vocab, L)],
              params=S(max_new_tokens=6)) for L in (80, 70, 45)]
    for i in range(3):
        t = 1.3 if i == 1 else 0.0
        reqs.append(G(prompt=[int(t) for t in rng.integers(0, vocab, 8 + i)],
                      params=S(max_new_tokens=8, temperature=t,
                               top_k=4 if t else 0)))
    return reqs


def _run_pair(cfgs, workload, *, ecfg=None, scfg=None, rl_accuracy=1.0,
              mb=4, cap=96):
    jcfg, cfg = cfgs
    jeng = JServingEngine(
        jcfg, max_batch=mb, capacity=cap, rl_accuracy=rl_accuracy, seed=0,
        scheduler_cfg=JSchedulerConfig(**scfg) if scfg else None,
        engine_cfg=JEngineConfig(**ecfg) if ecfg else None)
    params = params_from_jax({k: np.asarray(v) for k, v in
                              jeng.params.items()}, device="cpu",
                             dtype=torch.float32)
    eng = ServingEngine(
        cfg, params, max_batch=mb, capacity=cap, rl_accuracy=rl_accuracy,
        seed=0, scheduler_cfg=SchedulerConfig(**scfg) if scfg else None,
        engine_cfg=EngineConfig(**ecfg) if ecfg else None, device="cpu")
    jreqs = workload(JGenRequest, JSamplingParams, cfg.vocab_size)
    reqs = workload(GenRequest, SamplingParams, cfg.vocab_size)
    jeng.run(jreqs)
    eng.run(reqs)
    return (jeng, jreqs), (eng, reqs)


def _fingerprint(eng, reqs):
    """``test_engine_async._fingerprint`` with sampled rows reduced to
    their length, plus the engine's sync and dispatch counters."""
    per_req = [(g.rid, tuple(g.output) if g.params.temperature == 0.0
                else len(g.output), g.t_done) for g in reqs]
    s = eng.scheduler
    sched = (tuple(s.iter_completion_counts),
             tuple((r.rid, r.t_complete, r.generated, r.n_preemptions)
                   for r in s.completed),
             s.n_preempt_free, s.n_preempt_swap, s.n_underprov,
             s.n_hosted, s.n_reserve_rescues)
    counters = (dict(eng.sync_counts), eng.decode_iters,
                eng.n_decode_dispatches, eng.n_prefill_waves,
                eng.n_chunk_calls, eng.n_prefill_chunks,
                eng.max_chunk_items_per_call, eng.n_tokens_drained)
    return per_req, sched, counters


def _assert_equal(pair):
    (jeng, jreqs), (eng, reqs) = pair
    for g in reqs:
        assert g.t_done is not None and g.status == "completed"
        assert len(g.output) == g.params.max_new_tokens
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)


def test_default_config_with_megastep_windows(cfgs):
    pair = _run_pair(cfgs, _megastep_workload)
    _assert_equal(pair)
    (jeng, _), (eng, _) = pair
    assert eng.ecfg.decode_megastep == 8
    assert eng.n_mega_windows > 0                    # a window with K > 1
    assert eng.n_decode_dispatches < eng.decode_iters


def test_default_config_mixed_short_requests(cfgs):
    _assert_equal(_run_pair(cfgs, _async_workload))


def test_legacy_padded_prefill_and_sync_decode(cfgs):
    pair = _run_pair(cfgs, _async_workload, ecfg=LEGACY)
    _assert_equal(pair)
    (_, _), (eng, _) = pair
    assert eng.sync_counts["drain_blocking"] == eng.decode_iters > 0
    assert {b for b, _ in eng._prefill_shapes} == {eng.max_batch}


@pytest.mark.parametrize("ecfg", [None, LEGACY], ids=["default", "legacy"])
def test_preemption_recompute_reprefill(cfgs, ecfg):
    scfg = dict(kvc_tokens=4 * 96, block_size=16, tfs=96, max_model_len=96,
                max_batch_reqs=4, pad_ratio=0.0, reserve_frac=0.0, bucket=8)
    pair = _run_pair(cfgs, _preempt_workload, ecfg=ecfg, scfg=scfg,
                     rl_accuracy=0.0)
    _assert_equal(pair)
    (jeng, _), (eng, _) = pair
    assert eng.scheduler.n_preempt_free > 0
    assert jeng.scheduler.n_preempt_free > 0


def test_preemption_host_swap_restore(cfgs):
    """offload_free=False routes under-provision through the swap path:
    de-slotted GTs are captured to the host pool and restored."""
    scfg = dict(kvc_tokens=4 * 96, block_size=16, tfs=96, max_model_len=96,
                max_batch_reqs=4, pad_ratio=0.0, reserve_frac=0.0, bucket=8,
                offload_free=False)
    pair = _run_pair(cfgs, _preempt_workload, scfg=scfg, rl_accuracy=0.0)
    _assert_equal(pair)
    (jeng, _), (eng, _) = pair
    assert eng.scheduler.n_preempt_swap > 0
    assert eng.n_swap_restores == jeng.n_swap_restores > 0
    assert eng.n_swap_captures == jeng.n_swap_captures


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per-chunk"])
def test_chunked_prefill_waves(cfgs, packed):
    scfg = dict(kvc_tokens=4 * 192, block_size=16, tfs=32,
                max_model_len=192, max_batch_reqs=4)
    pair = _run_pair(cfgs, _chunk_workload, scfg=scfg, cap=192,
                     ecfg=None if packed else dict(packed_chunk_prefill=False))
    _assert_equal(pair)
    (_, _), (eng, _) = pair
    assert eng.n_chunk_calls > 0 and eng.n_prefill_chunks >= 2
    if packed:
        assert eng.max_chunk_items_per_call >= 2     # a packed chunk wave


def test_eos_truncates_pressure_window(cfgs):
    """``test_engine_pressure``'s KVC-saturated workload, greedy, with an
    EOS token that fires mid-stream: megastep windows run with the device
    stop flag (queues are non-empty), EOS flags are read back once per
    window, and every decision matches the reference."""
    small = dict(layers=1)
    over = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                d_ff=256, vocab_size=256, **F32)
    pcfgs = (jax_config("qwen3_8b").reduced(**small).with_(**over),
             get_config("qwen3_8b").reduced(**small).with_(**over))
    scfg = dict(kvc_tokens=512, block_size=16, tfs=256, max_model_len=256,
                max_batch_reqs=8, reserve_frac=0.0, pad_ratio=0.0,
                bucket=16)

    def workload(eos):
        def make(G, S, vocab):
            rng = np.random.default_rng(0)
            return [G(prompt=[int(t) for t in rng.integers(0, vocab, 16)],
                      params=S(max_new_tokens=112, eos_token=eos))
                    for _ in range(12)]
        return make

    (_, probe), _ = _run_pair(pcfgs, workload(None), scfg=scfg, mb=8,
                              cap=256)
    eos = probe[0].output[len(probe[0].output) // 2]
    pair = _run_pair(pcfgs, workload(eos), scfg=scfg, mb=8, cap=256)
    (jeng, jreqs), (eng, reqs) = pair
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)
    assert any(len(g.output) < 112 for g in reqs)
    assert eng.sync_counts["eos_flags"] > 0 and eng.n_mega_windows > 0


def test_packed_chunk_layout():
    """Chunks [5, 8) and [0, 2) of two prompts: queries carry absolute
    positions and their chunk's segment; the key axis prepends one prefix
    view of Cp = 5 slots per chunk, valid below that chunk's start."""
    pos, seg, ppos, pseg, offs = packed_chunk_layout([5, 0], [3, 2], 64)
    inv = POS_INVALID
    assert pos.tolist() == [[5, 6, 7, 0, 1]]
    assert seg.tolist() == [[0, 0, 0, 1, 1]]
    assert ppos.tolist() == [[0, 1, 2, 3, 4, inv, inv, inv, inv, inv]]
    assert pseg.tolist() == [[0] * 5 + [1] * 5]
    assert offs.tolist() == [0, 3]
    _, _, ppos, _, _ = packed_chunk_layout([0, 0], [2, 2], 64)
    assert ppos.tolist() == [[inv, inv]]                 # Cp is at least 1


def test_profiler_ranges_own_each_phase(cfgs):
    """Under ``torch.profiler`` each prefill wave, chunk call and decode
    dispatch is one named range holding the model's matmuls."""
    from torch.profiler import ProfilerActivity, profile
    _, cfg = cfgs
    scfg = dict(kvc_tokens=4 * 192, block_size=16, tfs=32,
                max_model_len=192, max_batch_reqs=4)
    eng = ServingEngine(cfg, max_batch=4, capacity=192, seed=0,
                        scheduler_cfg=SchedulerConfig(**scfg), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(_chunk_workload(GenRequest, SamplingParams, cfg.vocab_size))
    count = {n: 0 for n in ("engine.prefill_wave", "engine.prefill_chunks",
                            "engine.decode")}
    holds_mm = dict.fromkeys(count, False)
    for ev in prof.events():
        if ev.key in count:
            count[ev.key] += 1
        elif ev.key == "aten::mm":
            up = ev.cpu_parent
            while up is not None and up.key not in count:
                up = up.cpu_parent
            if up is not None:
                holds_mm[up.key] = True
    assert count["engine.prefill_wave"] == eng.n_prefill_waves > 0
    assert count["engine.prefill_chunks"] == eng.n_chunk_calls > 0
    assert count["engine.decode"] >= eng.n_decode_dispatches > 0
    assert all(holds_mm.values())


def test_sampling_support_is_top_k():
    """Sampled rows only ever draw from their top-k set; greedy rows are
    the argmax; an all-greedy batch draws nothing from the generator."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    temps = torch.tensor([0.0, 1.3, 0.8, 2.0])
    top_ks = torch.tensor([0, 4, 1, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    topk = logits.topk(4, dim=-1).indices
    for _ in range(50):
        out = sample_in_graph(logits, gen, temps, top_ks, True, True)
        assert int(out[0]) == int(logits[0].argmax())
        assert int(out[1]) in topk[1].tolist()
        assert int(out[2]) == int(logits[2].argmax())     # top-1
    state = gen.get_state()
    sample_in_graph(logits, gen, torch.zeros(4), torch.zeros(4), False,
                    False)
    assert torch.equal(state, gen.get_state())


def test_entry_points_default_to_the_card(cfgs):
    """With no card and no explicit device the engine refuses to start."""
    _, cfg = cfgs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)


# --------------------------------------------------------------------- #
# host spans and first-token stamps
# --------------------------------------------------------------------- #
CHUNK_SCFG = dict(kvc_tokens=4 * 192, block_size=16, tfs=32,
                  max_model_len=192, max_batch_reqs=4)
STAMP_PATHS = {
    "megastep": (_megastep_workload, None, None),
    "chunks": (_chunk_workload, None, CHUNK_SCFG),
    "sync": (_async_workload, LEGACY, None),
}


def _serve_live(cfg, workload, *, ecfg=None, scfg=None, totals=None):
    """Serve on the host's monotonic clock, one request submitted every
    third step (arrivals land inside megastep windows)."""
    import time
    eng = ServingEngine(
        cfg, max_batch=4, capacity=192, seed=0, rl_accuracy=1.0,
        scheduler_cfg=SchedulerConfig(**scfg) if scfg else None,
        engine_cfg=EngineConfig(**ecfg) if ecfg else None, device="cpu")
    eng.spans = totals
    reqs = workload(GenRequest, SamplingParams, cfg.vocab_size)
    todo, steps = list(reqs), 0
    while todo or eng.has_work():
        if todo and steps % 3 == 0:
            eng.submit(todo.pop(0), time.monotonic())
        if eng.has_work():
            eng.step(time.monotonic())
        steps += 1
    eng.flush()
    return eng, reqs, steps


def test_span_totals_change_no_token_and_no_sync_count(cfgs):
    """Megastep windows (K = 8) behind a lag-2 readback ring give the same
    streams, ``sync_counts`` and dispatch counters with ``SpanTotals``
    attached as without; the totals count what the engine counts, and
    each nested span's time is at most its parent's."""
    from repro_torch.obs import SpanTotals
    _, cfg = cfgs
    bare, bare_reqs, _ = _serve_live(cfg, _megastep_workload)
    tot = SpanTotals()
    eng, reqs, steps = _serve_live(cfg, _megastep_workload, totals=tot)
    assert eng.ecfg.decode_megastep == 8 and eng.ecfg.readback_lag == 2
    assert [g.output for g in reqs] == [g.output for g in bare_reqs]
    assert eng.sync_counts == bare.sync_counts
    assert (eng.decode_iters, eng.n_decode_dispatches, eng.n_mega_windows) \
        == (bare.decode_iters, bare.n_decode_dispatches, bare.n_mega_windows)
    assert eng.n_mega_windows > 0
    calls, ns = tot.calls, tot.ns
    # a step whose plan is empty returns before ``finish_iteration``
    assert calls["scheduler.form_batch"] >= calls[
        "scheduler.finish_iteration"] > 0
    assert calls["engine.decode_launch"] == eng.n_decode_dispatches
    assert calls["engine.mega_replay"] + eng.n_decode_dispatches \
        - eng.n_mega_windows == eng.decode_iters
    assert calls["engine.prefill_wave"] == eng.n_prefill_waves
    assert calls["engine.admit"] > 0 and calls["engine.eos_readback"] == 0
    assert calls["kernels.decode_call"] >= cfg.num_layers * eng.decode_iters
    assert calls["kernels.flash_call"] >= cfg.num_layers
    assert ns["engine.decode"] >= ns["engine.decode_launch"] \
        >= ns["kernels.decode_call"] > 0
    assert ns["engine.prefill_wave"] >= ns["kernels.flash_call"] > 0


@pytest.mark.parametrize("path", sorted(STAMP_PATHS))
def test_first_token_stamps_follow_submit(cfgs, path):
    """Every completed request was submitted, then its first token
    sampled, then drained, on the host's monotonic clock; the sync path
    writes the token to ``output`` as it samples it."""
    _, cfg = cfgs
    workload, ecfg, scfg = STAMP_PATHS[path]
    eng, reqs, _ = _serve_live(cfg, workload, ecfg=ecfg, scfg=scfg)
    if path == "chunks":
        assert eng.n_prefill_chunks > 0
    for g in reqs:
        assert g.status == "completed"
        assert g.t_submit <= g.t_first_sampled <= g.t_first_drained
        if path == "sync":
            assert g.t_first_sampled == g.t_first_drained


def test_profiler_sees_only_the_readers_ranges(cfgs):
    """With ``SpanTotals`` attached under ``torch.profiler`` the totals
    hold every span, and the profiler no range but the four the
    benchmark's trace reader knows (any other's device shadow would read
    there as a kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import SpanTotals
    from repro_torch.obs.spans import PROFILER_RANGES
    _, cfg = cfgs
    tot = SpanTotals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_live(cfg, _chunk_workload, scfg=CHUNK_SCFG, totals=tot)
    names = {e.key for e in prof.events()}
    assert {"engine.drain", "engine.decode_launch", "scheduler.form_batch",
            "kernels.decode_call", "kernels.flash_call",
            "engine.prefill_chunks"} <= set(tot.calls)
    assert names & set(tot.calls) == PROFILER_RANGES & set(tot.calls) \
        == {"engine.prefill_wave", "engine.prefill_chunks", "engine.decode"}
