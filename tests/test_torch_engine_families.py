"""The port's engine on the three dense families no other engine test
serves, held against ``repro.serving.ServingEngine`` on the same weights
(``params_from_jax``) and requests, in float32: greedy streams, completion
times, scheduler decisions, ``sync_counts`` and the dispatch counters
equal, under megastep windows and under packed chunk waves.

* deepseek-coder-33b reduced to 14 query heads over 2 kv heads of 32
  (G = 7, the full model's 56 / 8: no power of two);
* stablelm-12b reduced to 4 query heads over 1 kv head of 160 (its head
  dim);
* musicgen-large reduced (MHA, 4 heads of 64).

Then both kernels' plain versions (``repro_torch.kernels.ref``) against
the JAX oracles (``repro.kernels.ref``) at G = 7: a packed prefill of
ragged segments and a paged decode under a shuffled block table.
Tolerances: 2e-5 in float32 (the two sum in other orders), 2e-2 in bf16
(inputs rounded alike, one bf16 rounding of the output on each side)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

from test_torch_engine import (_assert_equal, _chunk_workload,  # noqa: E402
                               _megastep_workload, _run_pair)

F32 = dict(dtype="float32", param_dtype="float32")
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# arch -> the reduced config's overrides, and its (heads, kv heads, hd)
FAMILIES = {
    "deepseek_coder_33b": (dict(num_heads=14, num_kv_heads=2, head_dim=32),
                           (14, 2, 32)),
    "stablelm_12b": (dict(num_heads=4, num_kv_heads=1, head_dim=160),
                     (4, 1, 160)),
    "musicgen_large": ({}, (4, 4, 64)),
}
CHUNKS = dict(kvc_tokens=4 * 192, block_size=16, tfs=32, max_model_len=192,
              max_batch_reqs=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the suite runs in parallel
    workers, and a pool of one thread per core in each oversubscribes the
    CPU (the engine's many small ops wait on each other's barriers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_engine_family_matches_reference(arch):
    over, shape = FAMILIES[arch]
    cfgs = (jax_config(arch).reduced().with_(**over, **F32),
            get_config(arch).reduced().with_(**over, **F32))
    cfg = cfgs[1]
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == shape
    pair = _run_pair(cfgs, _megastep_workload)
    _assert_equal(pair)
    (_, _), (eng, _) = pair
    assert eng.n_mega_windows > 0
    assert eng.n_decode_dispatches < eng.decode_iters
    pair = _run_pair(cfgs, _chunk_workload, scfg=CHUNKS, cap=192)
    _assert_equal(pair)
    (_, _), (eng, _) = pair
    assert eng.n_chunk_calls > 0 and eng.max_chunk_items_per_call >= 2


def _pair(a, dtype):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(
        np.array(a, np.float32)).to(TDT[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["flash_packed", "paged_decode"])
def test_plain_kernels_at_g7_match_reference(kernel, dtype):
    """G = 7: 14 query heads over 2 kv heads at hd 128."""
    rng = np.random.default_rng(7)
    H, K, hd = 14, 2, 128
    if kernel == "flash_packed":
        lens = (37, 64, 1, 90)              # ragged, across tile edges
        S = sum(lens)
        seg = np.repeat(np.arange(len(lens)), lens)[None].astype(np.int32)
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.standard_normal((1, S, n, hd)), dtype)
            for n in (H, K, K))
        got = ref.flash_attention(tq, tk, tv,
                                  segment_ids=torch.from_numpy(seg))
        want = jref.flash_attention(jq, jk, jv, causal=True,
                                    segment_ids=jnp.asarray(seg))
    else:
        B, page, MP = 4, 16, 5
        P = B * MP + 3
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.standard_normal(s), dtype)
            for s in ((B, H, hd), (P, page, K, hd), (P, page, K, hd)))
        bt = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
        cl = np.asarray([1, page, page + 1, MP * page], np.int32)
        got = ref.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                         torch.from_numpy(cl))
        want = jref.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                           jnp.asarray(cl))
    assert got.shape == tq.shape and got.dtype == TDT[dtype]
    _close(got, want, dtype)
