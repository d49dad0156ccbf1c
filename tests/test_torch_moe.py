"""The port's MoE (``repro_torch.models.moe``) held against
``repro.models.moe`` on the CPU, in float32, on the same weights
(``params_from_jax``) and inputs (numpy, seeded): ``moe_apply``'s output
and aux loss on reduced phi3.5-MoE and reduced arctic (dense residual),
at capacity factors with and without dropped tokens, and the prefill and
decode logits of both stacks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    JAX_TO_PORT, params_from_jax)

F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-4        # float32 logits / layer outputs: matmul order differs
ARCHS = ("phi3_5_moe_42b", "arctic_480b")


def _cfgs(arch, **over):
    return (jax_config(arch).reduced().with_(**F32, **over),
            get_config(arch).reduced().with_(**F32, **over))


def _weights(jcfg, seed=0):
    jp = jmodel.init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu", dtype=torch.float32)
    return jp, tp


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _expert_loads(jp_layer, x, k):
    """Assignments per expert under the reference's own router."""
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1]))
                           @ jp_layer["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    return np.bincount(np.asarray(idx).ravel(),
                       minlength=probs.shape[-1])


@pytest.mark.parametrize("arch,cf,shape", [
    ("phi3_5_moe_42b", 4.0, (2, 24)),     # cf = E: nothing drops
    ("phi3_5_moe_42b", 1.25, (3, 40)),    # the published factor
    ("phi3_5_moe_42b", 0.5, (2, 64)),     # the reference drops tokens
    ("phi3_5_moe_42b", 1.25, (4, 1)),     # a decode-sized call
    ("arctic_480b", 1.25, (2, 33)),
    ("arctic_480b", 0.5, (1, 70)),
])
def test_moe_apply_matches_jax(arch, cf, shape):
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _weights(jcfg)
    layer = 1
    jl = {k[len("A/moe/"):]: v[layer] for k, v in jp.items()
          if k.startswith("A/moe/")}
    tl = {k[len("moe."):]: tp[k][layer] for k in tp if k.startswith("moe.")}
    assert set(tl) == set(jl) == set(moe.moe_params(cfg))
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    y_j, aux_j = jmoe.moe_apply(jl, jcfg, jnp.asarray(x))
    y_t, aux_t = moe.moe_apply(tl, cfg, torch.from_numpy(x))
    _close(y_t, y_j)
    _close(aux_t, aux_j, 1e-5)
    assert moe.capacity(cfg, shape[0] * shape[1]) == jmoe.capacity(
        jcfg, shape[0] * shape[1])
    loads = _expert_loads(jl, x, cfg.experts_per_token)
    C = moe.capacity(cfg, shape[0] * shape[1])
    if cf == 0.5:
        assert loads.max() > C            # this case drops tokens
    if cf == cfg.num_experts:
        assert loads.max() <= C


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = moe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2]]
    _close(vals, jv, 0.0)


def test_moe_init_uses_the_reference_std_rule():
    """A stacked (L, E, d, f) expert weight draws with 1/sqrt(L*E*d) (the
    layer and expert axes in the fan-in), the router ten times smaller."""
    jcfg, cfg = _cfgs("phi3_5_moe_42b")
    jp, _ = _weights(jcfg)
    p = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for path in ("A/moe/router", "A/moe/w_gate", "A/moe/w_up",
                 "A/moe/w_down", "A/attn/wq"):
        want = float(np.std(np.asarray(jp[path])))
        got = float(p[JAX_TO_PORT[path]].std())
        assert abs(got - want) <= 0.05 * want, path
    L, E, d, f = p["moe.w_gate"].shape
    assert abs(float(p["moe.w_gate"].std()) - (L * E * d) ** -0.5) \
        <= 0.05 * (L * E * d) ** -0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_logits_match_jax(arch):
    """Whole stacks: the prefill's logits at every position and its K/V,
    then two decode steps over the seeded cache, at the published capacity
    factor."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, seed=1)
    assert set(tp) == set(model.param_tree(cfg))
    if arch == "arctic_480b":
        assert {"w_gate", "moe.w_gate"} <= set(tp)
    rng = np.random.default_rng(5)
    B, S = 2, 29
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = jmodel.prefill(jcfg, jp, jnp.asarray(toks))
    lt, ct = model.prefill(cfg, tp, torch.from_numpy(toks).long())
    _close(lt, lj)
    _close(ct["A"]["k"], cj["A"]["k"])
    cache_j = jmodel.seed_cache(jcfg, jmodel.init_cache(jcfg, B, 48), cj, S)
    cache_t = model.seed_cache(cfg, model.init_cache(cfg, B, 48), ct, S)
    for t in range(2):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full(B, S + t, np.int32)
        dj, cache_j = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt),
                                         jnp.asarray(pos), cache_j)
        dt, cache_t = model.decode_step(cfg, tp, torch.from_numpy(nxt).long(),
                                        torch.from_numpy(pos), cache_t)
        _close(dt, dj)
    _close(cache_t["A"]["v"], cache_j["A"]["v"])
