"""The port's engine on recurrent and hybrid stacks, and on the recompute
chunk path, held against ``repro.serving.ServingEngine`` on the same
weights and requests, in float32: greedy streams, completion times,
scheduler decisions, ``sync_counts`` and the dispatch counters equal. The
scenarios are the counterparts of the reference's own recurrent tests
(``tests/test_engine.py``, ``tests/test_engine_chunked.py``), zamba2-7b
reduced with megastep windows and an abort inside one and under
preemption, and qwen3-8b reduced with ``incremental_chunk_prefill=False``.
The disaggregated zamba2 fleet is in ``test_torch_cluster_recurrent.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import GenRequest as JGenRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import (GenRequest, SamplingParams,  # noqa: E402
                                 ServingEngine)

from test_torch_engine import _fingerprint, _run_pair  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
LEGACY = dict(async_decode=False, packed_prefill=False)
MAMBA_KW = dict(name="mamba-test", arch_type="ssm", num_layers=2, d_model=64,
                num_heads=2, num_kv_heads=2, head_dim=32, d_ff=0,
                vocab_size=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
                ssm_chunk=16, layer_pattern="MM", **F32)


def _cfgs(arch, **over):
    if arch == "mamba":
        return JaxModelConfig(**MAMBA_KW), ModelConfig(**MAMBA_KW)
    return (jax_config(arch).reduced().with_(**F32, **over),
            get_config(arch).reduced().with_(**F32, **over))


def _scfg(tfs, mb, cap):
    return dict(kvc_tokens=mb * cap, block_size=16, tfs=tfs,
                max_model_len=cap, max_batch_reqs=mb)


def _two_prompts(lens, n_out, seed):
    def make(G, S, vocab):
        rng = np.random.default_rng(seed)
        return [G(prompt=[int(t) for t in rng.integers(0, vocab, L)],
                  params=S(max_new_tokens=n_out)) for L in lens]
    return make


def _equal(pair):
    (jeng, jreqs), (eng, reqs) = pair
    for g in reqs:
        assert g.status == "completed"
        assert len(g.output) == g.params.max_new_tokens
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)
    return eng, reqs


@pytest.mark.parametrize("ecfg", [None, LEGACY], ids=["default", "legacy"])
def test_recurrent_model_exact_prefill_fallback(ecfg):
    """``test_recurrent_model_exact_prefill_fallback``: an xLSTM stack
    takes exact-shape prefill (no padding, no packing) and serves, on the
    async path and on the legacy sync one (whose decode masks idle rows'
    states the same way)."""
    eng, _ = _equal(_run_pair(_cfgs("xlstm_125m"), _two_prompts((5, 6), 4, 2),
                              mb=2, cap=64, ecfg=ecfg))
    assert not eng._pad_prefill and not eng._packed
    assert eng._prefill_shapes == {(1, 5), (1, 6)}


def test_hybrid_preemption_recomputes():
    """zamba2 reduced under an always-wrong predictor and a tight KVC:
    preempted requests have no portable image (no host-swap capture) and
    re-prefill prompt + generated at exact shape, states and shared K/V
    alike."""
    from test_torch_engine import _preempt_workload
    scfg = dict(kvc_tokens=4 * 96, block_size=16, tfs=96, max_model_len=96,
                max_batch_reqs=4, pad_ratio=0.0, reserve_frac=0.0, bucket=8)
    pair = _run_pair(_cfgs("zamba2_7b"), _preempt_workload, scfg=scfg,
                     rl_accuracy=0.0)
    eng, _ = _equal(pair)
    assert eng.scheduler.n_preempt_free > 0
    assert eng.n_swap_captures == pair[0][0].n_swap_captures == 0


@pytest.mark.parametrize("arch", ["xlstm_125m", "mamba"])
def test_recurrent_state_carry_matches_recompute(arch):
    """``test_recurrent_state_carry_matches_recompute`` and
    ``test_mamba_state_carry_matches_recompute``: pure-recurrent stacks
    carry the per-request state snapshot across chunks (the conv history
    and h cross chunk boundaries); each path equals the reference's, and
    the two paths give the same fingerprint."""
    cfgs = _cfgs(arch)
    wl = _two_prompts((40, 7) if arch != "mamba" else (50, 9),
                      5 if arch != "mamba" else 4, 3 if arch != "mamba" else 9)
    scfg = _scfg(16, 2, 96)
    carry, reqs_c = _equal(_run_pair(cfgs, wl, scfg=scfg, mb=2, cap=96))
    rec, reqs_r = _equal(_run_pair(
        cfgs, wl, scfg=scfg, mb=2, cap=96,
        ecfg=dict(incremental_chunk_prefill=False)))
    assert carry._chunk_rec and not rec._chunk_rec
    assert carry.n_prefill_chunks == rec.n_prefill_chunks >= 2
    assert not carry._rec_state                     # popped at completion
    assert _fingerprint(carry, reqs_c) == _fingerprint(rec, reqs_r)


def test_recurrent_stack_chunk_fallback():
    """``test_recurrent_stack_chunk_fallback``: with the state carry off,
    xLSTM chunks recompute from the start and still give the whole-prompt
    streams."""
    cfgs = _cfgs("xlstm_125m")
    wl = _two_prompts((40, 7), 5, 3)
    chunked, reqs_c = _equal(_run_pair(
        cfgs, wl, scfg=_scfg(16, 2, 96), mb=2, cap=96,
        ecfg=dict(incremental_chunk_prefill=False)))
    _, reqs_w = _equal(_run_pair(cfgs, wl, scfg=_scfg(96, 2, 96), mb=2,
                                 cap=96))
    assert not chunked._chunk_incremental and not chunked._chunk_rec
    assert chunked.n_prefill_chunks >= 2
    assert [g.output for g in reqs_c] == [g.output for g in reqs_w]


def test_hybrid_chunks_recompute():
    """zamba2 reduced (Mamba2 + the shared attention block) has neither a
    K/V-prefix view nor a pure state snapshot: its chunks recompute their
    prefix and reseed the row, K/V and states alike."""
    eng, _ = _equal(_run_pair(_cfgs("zamba2_7b"), _two_prompts((45, 8), 6, 4),
                              scfg=_scfg(16, 2, 96), mb=2, cap=96))
    assert not (eng._chunk_incremental or eng._chunk_rec)
    assert eng.n_prefill_chunks >= 2 and "shared" in eng.caches


def test_zamba2_megastep_windows_with_abort():
    """zamba2 reduced, default config: megastep windows keep idle rows'
    recurrent state; an abort issued inside an open window is deferred to
    its end on both sides."""
    cfgs = _cfgs("zamba2_7b")

    def make(G, S, vocab):
        rng = np.random.default_rng(0)
        return [G(prompt=[int(t) for t in rng.integers(
            0, vocab, int(rng.integers(4, 18)))],
            params=S(max_new_tokens=int(rng.integers(24, 40))))
            for _ in range(4)]

    def drive(eng, reqs):
        for g in reqs:
            eng.submit(g, 0.0)
        t, opened = 0.0, None
        while eng.has_work() and t < 500:
            t += 1.0
            eng.step(t)
            if opened is None and eng._mega_left > 0 and t > 4:
                opened = t
                assert eng.abort(reqs[2].rid, t)
                assert reqs[2].status is None          # deferred
        eng.flush()
        return opened

    jcfg, cfg = cfgs
    jeng = JServingEngine(jcfg, max_batch=4, capacity=96, rl_accuracy=1.0,
                          seed=0)
    eng = ServingEngine(cfg, params_from_jax(
        {k: np.asarray(v) for k, v in jeng.params.items()}, device="cpu",
        dtype=torch.float32), max_batch=4, capacity=96, rl_accuracy=1.0,
        seed=0, device="cpu")
    jreqs = make(JGenRequest, JSamplingParams, cfg.vocab_size)
    reqs = make(GenRequest, SamplingParams, cfg.vocab_size)
    assert drive(jeng, jreqs) == drive(eng, reqs) is not None
    assert [g.status for g in reqs] == [g.status for g in jreqs]
    assert reqs[2].status == "aborted"
    assert eng.n_mega_windows > 0
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)


def test_qwen3_recompute_chunk_path():
    """``incremental_chunk_prefill=False`` on a pure-attention stack: every
    chunk re-runs its prompt's prefix and reseeds the row."""
    from test_torch_engine import _chunk_workload
    cfgs = (jax_config("qwen3_8b").reduced(d_model=128).with_(**F32),
            get_config("qwen3_8b").reduced(d_model=128).with_(**F32))
    eng, _ = _equal(_run_pair(cfgs, _chunk_workload, scfg=_scfg(32, 4, 192),
                              cap=192,
                              ecfg=dict(incremental_chunk_prefill=False)))
    assert not eng._chunk_incremental and not eng._chunk_packed
    assert eng.n_prefill_chunks >= 2 and eng.max_chunk_items_per_call == 1
