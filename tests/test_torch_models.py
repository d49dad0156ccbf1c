"""The port's model layers held against ``repro.models`` on the CPU, in
float32, on the same weights (``params_from_jax``) and the same inputs
(numpy, seeded). Reference attention runs with ``impl="pallas"`` (interpret
mode), whose float32 softmax numerics the port's kernels copy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.ref import POS_INVALID  # noqa: E402
from repro_torch.models import attention, common, model  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    JAX_TO_PORT, params_from_jax)

F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-4        # float32 logits / layer outputs: matmul order differs


@pytest.fixture(scope="module")
def cfgs():
    return (jax_config("qwen3_8b").reduced(d_model=128).with_(**F32),
            get_config("qwen3_8b").reduced(d_model=128).with_(**F32))


@pytest.fixture(scope="module")
def weights(cfgs):
    jcfg, cfg = cfgs
    jp = jmodel.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu", dtype=torch.float32)
    return jp, tp


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


# --------------------------------------------------------------------------- #
# numerics
# --------------------------------------------------------------------------- #
def test_rms_norm_rope_swiglu_softcap_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(scale), 1e-5),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    pos = rng.integers(0, 5000, (2, 7))
    _close(common.apply_rope(_t(x), _t(pos, torch.int32), 1e6),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-6)
    _close(common.rope_freqs(32, 1e6), jcommon.rope_freqs(32, 1e6), 1e-6)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    _close(common.swiglu(_t(h), _t(wg), _t(wu), _t(wd)),
           jcommon.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd))), 1e-6)
    s = rng.standard_normal((5, 9)).astype(np.float32) * 40
    _close(common.softcap(_t(s), 30.0), jcommon.softcap(jnp.asarray(s), 30.0),
           1e-6)
    assert common.softcap(_t(s), None) is not None


def test_params_from_jax_roundtrip(cfgs):
    """bf16 reference weights come across exactly (through float32), under
    the names of the port's own parameter tree, and map back unchanged."""
    jcfg, cfg = cfgs
    jcfg16, cfg16 = jcfg.with_(param_dtype="bfloat16"), \
        cfg.with_(param_dtype="bfloat16")
    jp = jmodel.init(jcfg16, jax.random.PRNGKey(1))
    flat = {k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu", dtype=torch.bfloat16)
    assert set(tp) == set(model.param_tree(cfg16))
    for name, meta in model.param_tree(cfg16).items():
        assert tuple(tp[name].shape) == meta.shape, name
    port_to_jax = {v: k for k, v in JAX_TO_PORT.items()}
    back = {port_to_jax[n]: t.float().numpy() for n, t in tp.items()}
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert set(JAX_TO_PORT) >= set(jp)
    with pytest.raises(NotImplementedError):
        params_from_jax({"M/ssm/A": np.zeros(2)}, device="cpu",
                        dtype=torch.float32)


def test_init_uses_the_reference_std_rule(cfgs, weights):
    """Same std per tensor as the reference's draws (fan-in over every axis
    but the last, the stacked layer axis included), ones for norms."""
    _, cfg = cfgs
    jp, _ = weights
    gen = torch.Generator().manual_seed(0)
    p = model.init(cfg, gen, "cpu")
    assert torch.equal(p["attn_norm"], torch.ones_like(p["attn_norm"]))
    for path in jp:
        name = JAX_TO_PORT[path]
        want = float(np.std(np.asarray(jp[path])))
        assert abs(float(p[name].std()) - want) <= 0.05 * want + 1e-6, name
    again = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


# --------------------------------------------------------------------------- #
# attention layer, every form
# --------------------------------------------------------------------------- #
def _layer(jp, tp, cfg, layer=1):
    jl = {k[len("A/attn/"):]: v[layer] for k, v in jp.items()
          if k.startswith("A/attn/")}
    tl = {k: tp[k][layer] for k in attention.attn_params(cfg)}
    return jl, tl


@pytest.mark.parametrize("form", ["plain", "segments", "prefix_len",
                                  "prefix_positions"])
def test_attn_prefill_matches_jax_pallas(cfgs, weights, form):
    jcfg, cfg = cfgs
    jl, tl = _layer(*weights, cfg)
    rng = np.random.default_rng(7)
    d, K, hd = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, C = (1, 40, 32) if form in ("segments", "prefix_positions") \
        else (2, 24, 32)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jkw, tkw = {}, {}
    if form == "segments":
        seg = np.repeat([0, 1, 2], [15, 9, 16])[None].astype(np.int32)
        pos = np.concatenate([np.arange(15), np.arange(9),
                              np.arange(16)])[None].astype(np.int32)
        jkw["segment_ids"], tkw["segment_ids"] = jnp.asarray(seg), _t(
            seg, torch.int32)
    if form in ("prefix_len", "prefix_positions"):
        pk = rng.standard_normal((B, C, K, hd)).astype(np.float32)
        pv = rng.standard_normal((B, C, K, hd)).astype(np.float32)
        jkw.update(prefix_k=jnp.asarray(pk), prefix_v=jnp.asarray(pv))
        tkw.update(prefix_k=_t(pk), prefix_v=_t(pv))
    if form == "prefix_len":
        start = 19
        pos = (start + pos).astype(np.int32)
        jkw["prefix_len"], tkw["prefix_len"] = jnp.int32(start), start
    if form == "prefix_positions":
        # two chunk segments: starts 12 and 0 over one shared prefix axis
        # of two 16-slot views
        seg = np.repeat([0, 1], [22, 18])[None].astype(np.int32)
        pos = np.concatenate([12 + np.arange(22),
                              np.arange(18)])[None].astype(np.int32)
        slot = np.arange(16)
        ppos = np.concatenate([np.where(slot < 12, slot, POS_INVALID),
                               np.full(16, POS_INVALID)])[None]
        pseg = np.repeat([0, 1], 16)[None]
        for name, a in (("segment_ids", seg), ("prefix_positions", ppos),
                        ("prefix_segment_ids", pseg)):
            jkw[name] = jnp.asarray(a, jnp.int32)
            tkw[name] = _t(a, torch.int32)
    y_j, (k_j, v_j) = jattn.attn_prefill(jl, jcfg, jnp.asarray(x),
                                         jnp.asarray(pos), impl="pallas",
                                         **jkw)
    y_t, (k_t, v_t) = attention.attn_prefill(tl, cfg, _t(x),
                                             _t(pos, torch.int32), **tkw)
    _close(y_t, y_j, TOL)
    _close(k_t, k_j, TOL)
    _close(v_t, v_j, TOL)


def test_attn_decode_matches_jax_pallas(cfgs, weights):
    """Writes the new K/V first (in place, active rows only), then
    attends — the same output and cache as the reference."""
    jcfg, cfg = cfgs
    jl, tl = _layer(*weights, cfg, layer=0)
    rng = np.random.default_rng(9)
    B, C = 3, 48
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    pos = np.asarray([0, 17, C - 1], np.int32)
    y_j, (ck_j, cv_j) = jattn.attn_decode(jl, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), jnp.asarray(ck),
                                          jnp.asarray(cv), impl="pallas")
    tk, tv = _t(ck), _t(cv)
    y_t = attention.attn_decode(tl, cfg, _t(x), _t(pos, torch.int32), tk, tv)
    _close(y_t, y_j, TOL)
    _close(tk, ck_j, TOL)
    _close(tv, cv_j, TOL)
    # an inactive row keeps its cache row untouched
    tk2, tv2 = _t(ck), _t(cv)
    attention.attn_decode(tl, cfg, _t(x), _t(pos, torch.int32), tk2, tv2,
                          active=torch.tensor([True, False, True]))
    assert torch.equal(tk2[1], _t(ck)[1]) and torch.equal(tv2[1], _t(cv)[1])
    _close(tk2[0], ck_j[0], TOL)


# --------------------------------------------------------------------------- #
# whole model
# --------------------------------------------------------------------------- #
def test_prefill_and_decode_logits_match_jax(cfgs, weights):
    jcfg, cfg = cfgs
    jp, tp = weights
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    lj, cj = jmodel.prefill(jcfg, jp, jnp.asarray(toks), impl="pallas",
                            last_only=True)
    lt, ct = model.prefill(cfg, tp, _t(toks, torch.long), last_only=True)
    _close(lt, lj, TOL)
    _close(ct["A"]["k"], cj["A"]["k"], TOL)
    full_j, _ = jmodel.prefill(jcfg, jp, jnp.asarray(toks), impl="pallas")
    full_t, _ = model.prefill(cfg, tp, _t(toks, torch.long))
    _close(full_t, full_j, TOL)
    # one decode step over a seeded cache of capacity 32
    cache_j = jmodel.seed_cache(jcfg, jmodel.init_cache(jcfg, 2, 32), cj, 21)
    cache_t = model.seed_cache(cfg, model.init_cache(cfg, 2, 32), ct, 21)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.asarray([21, 21], np.int32)
    dj, cache_j = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt),
                                     jnp.asarray(pos), cache_j, impl="pallas")
    dt, cache_t = model.decode_step(cfg, tp, _t(nxt, torch.long),
                                    _t(pos, torch.int32), cache_t)
    _close(dt, dj, TOL)
    _close(cache_t["A"]["v"], cache_j["A"]["v"], TOL)


def _jax_greedy(cfg, params, prompt, n):
    """``tests/test_engine.py:_ref_greedy``: prefill, seed, greedy decode."""
    toks = jnp.asarray(prompt, jnp.int32)[None]
    logits, caches = jmodel.prefill(cfg, params, toks)
    cache = jmodel.init_cache(cfg, 1, capacity=128, dtype=jnp.float32)
    cache = jmodel.seed_cache(cfg, cache, caches, len(prompt))
    cur = int(jnp.argmax(logits[0, -1]))
    out = [cur]
    for i in range(n - 1):
        lg, cache = jmodel.decode_step(
            cfg, params, jnp.asarray([[cur]], jnp.int32),
            jnp.asarray([len(prompt) + i], jnp.int32), cache)
        cur = int(jnp.argmax(lg[0]))
        out.append(cur)
    return out


def _port_greedy(cfg, params, prompt, n):
    toks = torch.tensor([prompt], dtype=torch.long)
    logits, caches = model.prefill(cfg, params, toks, last_only=True)
    cache = model.seed_cache(cfg, model.init_cache(cfg, 1, 128), caches,
                             len(prompt))
    cur = int(logits[0].argmax())
    out = [cur]
    for i in range(n - 1):
        lg, cache = model.decode_step(
            cfg, params, torch.tensor([[cur]]),
            torch.tensor([len(prompt) + i], dtype=torch.int32), cache)
        cur = int(lg[0].argmax())
        out.append(cur)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_stream_matches_reference(cfgs, weights, seed):
    jcfg, cfg = cfgs
    jp, tp = weights
    rng = np.random.default_rng(seed)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(4, 20)))]
    assert _port_greedy(cfg, tp, prompt, 10) == _jax_greedy(jcfg, jp,
                                                            prompt, 10)


@pytest.mark.parametrize("arch", list_archs(include_paper_model=True))
def test_every_config_builds(arch):
    """Every config in the registry builds in the port, reduced: its
    parameter tree, seeded init, decode caches (the reference's leaves and
    shapes) and a prefill (with frontend embeddings where it has a
    frontend); the weight bridge maps every path of the reference's tree
    onto the port's names and shapes."""
    jcfg = jax_config(arch).reduced().with_(**F32)
    cfg = get_config(arch).reduced().with_(**F32)
    tree, jtree = model.param_tree(cfg), jmodel.param_tree(jcfg)
    assert set(jtree) <= set(JAX_TO_PORT)
    assert {JAX_TO_PORT[k] for k in jtree} == set(tree)
    for path, meta in jtree.items():
        assert tree[JAX_TO_PORT[path]].shape == tuple(meta.shape), path
    p = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: m.shape for k, m in tree.items()}
    cache = model.init_cache(cfg, 2, 32)
    jcache = jmodel.init_cache(jcfg, 2, 32)
    assert {kind: {n: tuple(a.shape) for n, a in sub.items()}
            for kind, sub in cache.items()} == {
        kind: {n: tuple(a.shape) for n, a in sub.items()}
        for kind, sub in jcache.items()}
    F = cfg.frontend_tokens if cfg.frontend else 0
    embeds = torch.zeros((2, F, cfg.d_model)) if F else None
    logits, _ = model.prefill(cfg, p, torch.zeros((2, 5), dtype=torch.long),
                              embeds=embeds)
    assert logits.shape == (2, F + 5, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
