"""Decode with inactive rows, and the engine on reduced arctic-480b (a
dense residual FFN beside a MoE of 4 experts), held against the reference
in float32.

The reference's ``decode_step`` writes every row's new key and value and
then attends; its engine throws the inactive rows' writes away after the
step. A MoE decode call routes every row, inactive ones too, into experts
whose ``capacity(B)`` slots all rows share, so an inactive row's hidden
state decides which active tokens drop once the capacity binds. The port
must compute every row as the reference does and leave the inactive rows'
cache slots as they were, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

from test_torch_engine import _megastep_workload, _run_pair  # noqa: E402
from test_torch_engine_moe import F32, LEGACY, _equal, run_drops  # noqa: E402

ARCH = "arctic_480b"
TOL = 2e-5       # of max|logit|: float32, the matmul order differs
B = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    return (jax_config(arch).reduced().with_(**F32, **over),
            get_config(arch).reduced().with_(**F32, **over))


def _decode_pair(arch, cap, lo, **over):
    """One decode call of ``B`` rows over caches filled from a seed, with
    positions in [lo, 2 cap) and about half the rows active: the
    reference's logits and caches, and the port's with the ``active``
    mask, beside the port's caches before the call."""
    jcfg, cfg = _cfgs(arch, **over)
    jp = jmodel.init(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(17)
    jc = jmodel.init_cache(jcfg, B, cap, dtype=jnp.float32)
    tc = model.init_cache(cfg, B, cap, device="cpu")
    for name in ("k", "v"):
        a = rng.standard_normal(jc["A"][name].shape).astype(np.float32)
        jc["A"][name] = jnp.asarray(a)
        tc["A"][name] = torch.from_numpy(a.copy())
    toks = rng.integers(0, cfg.vocab_size, (B, 1))
    pos = rng.integers(lo, 2 * cap, B).astype(np.int32)
    if cfg.sliding_window is None:
        pos = np.minimum(pos, cap - 1)
    active = rng.random(B) < 0.5
    active[:2] = (True, False)
    before = {n: t.clone() for n, t in tc["A"].items()}
    lj, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(pos), jc)
    lt, tc = model.decode_step(cfg, tp, torch.from_numpy(toks).long(),
                               torch.from_numpy(pos), tc,
                               active=torch.from_numpy(active))
    return cfg, np.asarray(lj), lt.numpy(), jc, tc, before, active


@pytest.mark.parametrize("arch,over", [
    ("qwen3_8b", {}),
    ("phi3_5_moe_42b", dict(capacity_factor=0.5)),
    ("arctic_480b", dict(capacity_factor=0.5)),
    ("mistral_nemo_12b", {}),
], ids=["qwen3", "phi3.5-moe", "arctic", "mistral-nemo-ring"])
def test_decode_step_inactive_rows_match_the_reference(arch, over):
    """Every row's logits, inactive rows too, equal the reference's; the
    active rows' slots hold the reference's new K/V and the inactive rows'
    caches are bitwise what they were. Phi3.5-MoE and arctic route 16
    rows at capacity factor 0.5, where an expert's 4 slots bind;
    mistral-nemo's caches are rings of its 64-token window, written past
    their wrap."""
    cap = 64 if arch == "mistral_nemo_12b" else 40
    cfg, lj, lt, jc, tc, before, active = _decode_pair(arch, cap, 8, **over)
    assert active.any() and not active.all()
    np.testing.assert_allclose(lt, lj, rtol=0,
                               atol=TOL * float(np.abs(lj).max()))
    for name in ("k", "v"):
        got, ref = tc["A"][name].numpy(), np.asarray(jc["A"][name])
        assert np.array_equal(got[:, ~active],
                              before[name].numpy()[:, ~active])
        np.testing.assert_allclose(got[:, active], ref[:, active],
                                   rtol=0, atol=1e-5)


def test_arctic_megastep_windows():
    eng = _equal(_run_pair(_cfgs(ARCH), _megastep_workload))
    assert eng.cfg.moe_dense_residual and eng.n_mega_windows > 0


@pytest.mark.parametrize("ecfg", [None, LEGACY], ids=["megastep", "legacy"])
def test_arctic_decode_drops_like_the_reference(ecfg, monkeypatch):
    """``test_moe_decode_drops_like_the_reference`` on arctic: 16 rows
    route at ``capacity_factor=0.5`` while some of them are inactive, and
    the streams, decisions and counters equal the reference engine's."""
    run_drops(_cfgs(ARCH, capacity_factor=0.5), ecfg, monkeypatch)
