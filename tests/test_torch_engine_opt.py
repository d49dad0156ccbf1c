"""The port's engine on opt-13b, the reference launcher's default model
(MHA: 4 heads of 64 with 4 kv heads, no qk-norm, rope theta 1e4, vocab
512 in ``.reduced()``), held against ``repro.serving.ServingEngine`` on the
same weights and requests, in float32: greedy streams, completion times,
scheduler decisions, ``sync_counts``, the dispatch counters and the swap
counters equal, under megastep windows, host-swap restores under KV
pressure and packed chunk waves. Then ``repro_torch.launch.serve`` with no
``--arch``: the simulator prints the reference's lines, and the engine
serves opt-13b."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

from test_torch_engine import (_assert_equal, _chunk_workload,  # noqa: E402
                               _megastep_workload, _preempt_workload,
                               _run_pair)

F32 = dict(dtype="float32", param_dtype="float32")
ARCH = "opt_13b"


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jax_config(ARCH).reduced().with_(**F32)
    cfg = get_config(ARCH).reduced().with_(**F32)
    assert cfg.num_kv_heads == cfg.num_heads and not cfg.use_qk_norm
    return jcfg, cfg


def test_opt_megastep_windows(cfgs):
    pair = _run_pair(cfgs, _megastep_workload)
    _assert_equal(pair)
    (_, _), (eng, _) = pair
    assert eng.n_mega_windows > 0
    assert eng.n_decode_dispatches < eng.decode_iters


def test_opt_host_swap_restore_under_pressure(cfgs):
    """offload_free=False under an always-wrong predictor: de-slotted GTs
    are captured to the host pool and restored."""
    scfg = dict(kvc_tokens=4 * 96, block_size=16, tfs=96, max_model_len=96,
                max_batch_reqs=4, pad_ratio=0.0, reserve_frac=0.0, bucket=8,
                offload_free=False)
    pair = _run_pair(cfgs, _preempt_workload, scfg=scfg, rl_accuracy=0.0)
    _assert_equal(pair)
    (jeng, _), (eng, _) = pair
    assert eng.scheduler.n_preempt_swap > 0
    assert eng.n_swap_restores == jeng.n_swap_restores > 0
    assert (eng.n_swap_captures, eng.n_swap_drops, eng.n_swap_rejects) == \
        (jeng.n_swap_captures, jeng.n_swap_drops, jeng.n_swap_rejects)


def test_opt_packed_chunk_waves(cfgs):
    scfg = dict(kvc_tokens=4 * 192, block_size=16, tfs=32,
                max_model_len=192, max_batch_reqs=4)
    pair = _run_pair(cfgs, _chunk_workload, scfg=scfg, cap=192)
    _assert_equal(pair)
    (_, _), (eng, _) = pair
    assert eng.n_chunk_calls > 0 and eng.max_chunk_items_per_call >= 2


def test_serve_sim_without_arch_prints_the_reference_lines(capsys):
    argv = "--sim --trace sharegpt --requests 120 --rate 5.0".split()
    assert jserve.main(argv) == 0
    want = capsys.readouterr().out
    assert serve.main(argv) == 0
    assert capsys.readouterr().out == want and want


def test_serve_engine_without_arch_serves_opt_13b(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3",
                       "--capacity", "96"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3" in out and "arch=opt-13b" in out
    assert f"d_model={get_config(ARCH).reduced().d_model}" in out
