"""The port's recurrent and hybrid layers held against ``repro.models`` on
the CPU, in float32, on the same weights (``params_from_jax``) and inputs
(numpy, seeded): Mamba2 (SSD prefill below, at and above ``ssm_chunk``,
with and without a resumed state, and decode), mLSTM and sLSTM, and whole
models (zamba2-7b and xlstm-125m reduced, a pure-Mamba stack). Reference
attention runs with ``impl="pallas"`` (interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model, ssm, xlstm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-4        # float32: matmul and reduction order differ
MAMBA_KW = dict(name="mamba-test", arch_type="ssm", num_layers=2, d_model=64,
                num_heads=2, num_kv_heads=2, head_dim=32, d_ff=0,
                vocab_size=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
                ssm_chunk=16, layer_pattern="MM", **F32)


def _cfgs(arch):
    if arch == "mamba":
        return JaxModelConfig(**MAMBA_KW), ModelConfig(**MAMBA_KW)
    return (jax_config(arch).reduced().with_(**F32),
            get_config(arch).reduced().with_(**F32))


def _weights(jcfg, seed=0):
    """Reference weights with every 1-D leaf (norm scales, biases, A_log,
    D, dt_bias, gates) moved off its constant init, so each one matters."""
    jp = jmodel.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in jp.items():
        a = np.asarray(v, np.float32)
        if a.ndim <= 2 and "/" in k and k.split("/")[-1] not in (
                "in_proj", "out_proj", "conv_w", "w_in", "down", "wq", "wk",
                "wv", "wo", "wi", "wf", "w_gate", "w_up", "w_down"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        flat[k] = a
    jp = {k: jnp.asarray(a) for k, a in flat.items()}
    return jp, params_from_jax(flat, device="cpu", dtype=torch.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _close_tree(t_tree, j_tree, tol=TOL):
    assert set(t_tree) == set(j_tree)
    for k in j_tree:
        if isinstance(j_tree[k], dict):
            _close_tree(t_tree[k], j_tree[k], tol)
        else:
            _close(t_tree[k], j_tree[k], tol)


def _jlayer(jp, prefix, i):
    return {k[len(prefix):]: v[i] for k, v in jp.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def zamba():
    jcfg, cfg = _cfgs("zamba2_7b")
    return jcfg, cfg, *_weights(jcfg)


@pytest.fixture(scope="module")
def xl():
    jcfg, cfg = _cfgs("xlstm_125m")
    return jcfg, cfg, *_weights(jcfg, 1)


# --------------------------------------------------------------------------- #
# Mamba2
# --------------------------------------------------------------------------- #
def _random_ssm_state(cfg, B, rng):
    di, nh, n, conv_dim = ssm.ssm_dims(cfg)
    return {"h": rng.standard_normal((B, nh, cfg.ssm_head_dim, n)
                                     ).astype(np.float32) * 0.5,
            "conv": rng.standard_normal((B, cfg.ssm_conv_width - 1, conv_dim)
                                        ).astype(np.float32)}


@pytest.mark.parametrize("S", [20, 32, 75])
@pytest.mark.parametrize("resume", [False, True])
def test_ssm_prefill_matches_jax(zamba, S, resume):
    """ssm_chunk is 32: S below, at and above it (75 pads to 96 with dt =
    0), from the zero state and resuming a state."""
    jcfg, cfg, jp, tp = zamba
    rng = np.random.default_rng(S + 100 * resume)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    init = _random_ssm_state(cfg, 2, rng) if resume else None
    y_j, c_j = jssm.ssm_prefill(
        _jlayer(jp, "M/ssm/", 1), jcfg, jnp.asarray(u),
        init=None if init is None else {k: jnp.asarray(v)
                                        for k, v in init.items()})
    y_t, c_t = ssm.ssm_prefill(
        model.layer_params(tp, cfg, "M", 1), cfg, _t(u),
        init=None if init is None else {k: _t(v) for k, v in init.items()})
    _close(y_t, y_j)
    _close_tree(c_t, c_j)


def test_ssm_decode_matches_jax(zamba):
    jcfg, cfg, jp, tp = zamba
    rng = np.random.default_rng(5)
    u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    st = _random_ssm_state(cfg, 3, rng)
    y_j, c_j = jssm.ssm_decode(_jlayer(jp, "M/ssm/", 0), jcfg,
                               jnp.asarray(u),
                               {k: jnp.asarray(v) for k, v in st.items()})
    cache = {k: _t(v) for k, v in st.items()}
    y_t, c_t = ssm.ssm_decode(model.layer_params(tp, cfg, "M", 0), cfg,
                              _t(u), cache)
    _close(y_t, y_j)
    _close_tree(c_t, c_j)
    assert torch.equal(cache["h"], _t(st["h"]))        # input untouched


def test_ssm_prefill_then_decode_equals_longer_prefill(zamba):
    """The conv history and h a prefill leaves resume exactly: prefill(S)
    then one decode step gives prefill(S + 1)'s last output."""
    _, cfg, _, tp = zamba
    p = model.layer_params(tp, cfg, "M", 0)
    u = _t(np.random.default_rng(2).standard_normal((1, 41, cfg.d_model)))
    y_full, c_full = ssm.ssm_prefill(p, cfg, u)
    _, c = ssm.ssm_prefill(p, cfg, u[:, :40])
    y1, c1 = ssm.ssm_decode(p, cfg, u[:, 40:], c)
    torch.testing.assert_close(y1[:, 0], y_full[:, 40], atol=TOL, rtol=TOL)
    torch.testing.assert_close(c1["h"], c_full["h"], atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------- #
# xLSTM
# --------------------------------------------------------------------------- #
def _xl_cell(xl, kind):
    jcfg, cfg, jp, tp = xl
    i = 0
    return (_jlayer(jp, f"{kind}/cell/", i),
            model.layer_params(tp, cfg, kind, i))


def _random_mlstm_state(cfg, B, rng):
    di, nh, hd = xlstm._dims(cfg)
    return {"C": rng.standard_normal((B, nh, hd, hd)).astype(np.float32),
            "n": rng.standard_normal((B, nh, hd)).astype(np.float32),
            "m": rng.standard_normal((B, nh)).astype(np.float32)}


def _random_slstm_state(cfg, B, rng):
    di, _, _ = xlstm._dims(cfg)
    st = {k: rng.standard_normal((B, di)).astype(np.float32)
          for k in ("c", "h", "m")}
    st["n"] = np.abs(rng.standard_normal((B, di))).astype(np.float32) + 0.5
    return st


@pytest.mark.parametrize("kind", ["X", "S"])
@pytest.mark.parametrize("S", [9, 32, 45])
@pytest.mark.parametrize("resume", [False, True])
def test_xlstm_prefill_matches_jax(xl, kind, S, resume):
    """mLSTM (chunks of ssm_chunk = 32: below, at and above) and sLSTM
    (sequential), from the empty memory and resuming a state."""
    jcfg, cfg, _, _ = xl
    jp_l, tp_l = _xl_cell(xl, kind)
    rng = np.random.default_rng(S + 7 * resume)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mk = _random_mlstm_state if kind == "X" else _random_slstm_state
    init = mk(cfg, 2, rng) if resume else None
    jf = jxlstm.mlstm_prefill if kind == "X" else jxlstm.slstm_prefill
    tf = xlstm.mlstm_prefill if kind == "X" else xlstm.slstm_prefill
    y_j, c_j = jf(jp_l, jcfg, jnp.asarray(x),
                  init=None if init is None else {k: jnp.asarray(v)
                                                  for k, v in init.items()})
    y_t, c_t = tf(tp_l, cfg, _t(x),
                  init=None if init is None else {k: _t(v)
                                                  for k, v in init.items()})
    _close(y_t, y_j)
    _close_tree(c_t, c_j)


@pytest.mark.parametrize("kind", ["X", "S"])
def test_xlstm_decode_matches_jax(xl, kind):
    jcfg, cfg, _, _ = xl
    jp_l, tp_l = _xl_cell(xl, kind)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    st = (_random_mlstm_state if kind == "X" else _random_slstm_state)(
        cfg, 3, rng)
    jf = jxlstm.mlstm_decode if kind == "X" else jxlstm.slstm_decode
    tf = xlstm.mlstm_decode if kind == "X" else xlstm.slstm_decode
    y_j, c_j = jf(jp_l, jcfg, jnp.asarray(x),
                  {k: jnp.asarray(v) for k, v in st.items()})
    y_t, c_t = tf(tp_l, cfg, _t(x), {k: _t(v) for k, v in st.items()})
    _close(y_t, y_j)
    _close_tree(c_t, c_j)


# --------------------------------------------------------------------------- #
# whole models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m", "mamba"])
def test_model_prefill_and_decode_match_jax(arch):
    """Prefill logits and caches, then two decode steps over the seeded
    cache with one row inactive in the second: logits, K/V and every
    recurrent leaf equal the reference's within 1e-4 (logits of active
    rows: an inactive row's are never read); the inactive row's state is
    left as it was, as under the engine's masked update."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, 3)
    assert set(tp) == set(model.param_tree(cfg))
    for name, meta in model.param_tree(cfg).items():
        assert tuple(tp[name].shape) == meta.shape, name
    rng = np.random.default_rng(4)
    B, S, cap = 2, 37, 64
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = jmodel.prefill(jcfg, jp, jnp.asarray(toks), impl="pallas")
    lt, ct = model.prefill(cfg, tp, _t(toks, torch.long))
    _close(lt, lj)
    _close_tree(ct, cj)
    cache_j = jmodel.seed_cache(jcfg, jmodel.init_cache(jcfg, B, cap), cj, S)
    cache_t = model.seed_cache(cfg, model.init_cache(cfg, B, cap), ct, S)
    _close_tree(cache_t, cache_j)
    for step, active in ((0, None), (1, np.array([True, False]))):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full(B, S + step, np.int32)
        before = {k: {n: a.clone() for n, a in sub.items()}
                  for k, sub in cache_t.items()}
        dj, new_j = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt),
                                       jnp.asarray(pos), cache_j,
                                       impl="pallas")
        dt, cache_t = model.decode_step(
            cfg, tp, _t(nxt, torch.long), _t(pos, torch.int32), cache_t,
            active=None if active is None else torch.from_numpy(active))
        rows = slice(None) if active is None else active
        _close(dt[rows], np.asarray(dj)[rows])   # (inactive rows unread)
        if active is None:
            cache_j = new_j
        else:   # the engine's masked select, on the reference's side
            m = jnp.asarray(active)
            cache_j = jax.tree.map(
                lambda o, n: jnp.where(
                    m.reshape((1, -1) + (1,) * (n.ndim - 2)), n, o),
                cache_j, new_j)
            for kind, sub in cache_t.items():
                for n, a in sub.items():
                    assert torch.equal(a[:, 1], before[kind][n][:, 1]), \
                        (kind, n)
        _close_tree(cache_t, cache_j)


def test_model_structure_matches_reference():
    """Segments, kind counts and shared invocations of every config the
    port runs, as the reference counts them; zamba2-7b at full depth runs
    13 shared invocations after layers 6, 12, ..., 78."""
    from repro.configs import list_archs
    for arch in list_archs():
        jcfg, cfg = jax_config(arch), get_config(arch)
        assert model.segments(cfg) == jmodel.segments(jcfg)
        assert model.kind_counts(cfg) == jmodel.kind_counts(jcfg)
        assert model.num_shared_invocations(cfg) == \
            jmodel.num_shared_invocations(jcfg)
    cfg = get_config("zamba2_7b")
    after = [i for i in range(cfg.num_layers)
             if model._shared_after(cfg, i, 0)]
    assert model.num_shared_invocations(cfg) == 13
    assert after == [6 * k - 1 for k in range(1, 14)]


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
def test_init_uses_the_reference_std_rule(arch):
    """Every recurrent and shared weight is drawn with the reference's std
    (fan-in over every axis but the last, ones and zeros where it has
    them), under the port's name for the reference path."""
    from repro_torch.models.weights import JAX_TO_PORT
    jcfg, cfg = _cfgs(arch)
    jp = jmodel.init(jcfg, jax.random.PRNGKey(0))
    p = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {JAX_TO_PORT[k] for k in jp} == set(p)
    for path, a in jp.items():
        t = p[JAX_TO_PORT[path]]
        want = float(np.std(np.asarray(a)))
        assert tuple(t.shape) == a.shape, path
        assert abs(float(t.std()) - want) <= 0.05 * want + 1e-6, path
        if want == 0.0:
            assert torch.equal(t, torch.from_numpy(np.array(a))), path
