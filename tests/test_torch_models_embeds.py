"""The port's embedding-frontend prefill held against ``repro.models.model``
on the CPU, in float32, on the same weights and inputs: reduced
phi3-vision (vision patches) and musicgen (audio conditioning frames) take
precomputed embeddings ahead of the tokens; the logits at every position,
the K/V, and decode steps after the prefill agree, and decode after an
embeds prefill agrees with one prefill over the whole sequence (the
reference's ``tests/test_models.py`` check, with ``prefill`` over the
whole sequence as the oracle)."""
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

F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-4
ARCHS = ("phi3_vision_4_2b", "musicgen_large")


def _setup(arch, seed=0):
    jcfg = jax_config(arch).reduced().with_(**F32)
    cfg = get_config(arch).reduced().with_(**F32)
    jp = jmodel.init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu", dtype=torch.float32)
    return jcfg, cfg, jp, tp


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_embeds_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    assert cfg.frontend and cfg.frontend_tokens == 8
    rng = np.random.default_rng(3)
    B, F, S, T = 2, cfg.frontend_tokens, 21, 3
    toks = rng.integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    emb = (0.02 * rng.standard_normal((B, F, cfg.d_model))).astype(np.float32)
    lj, cj = jmodel.prefill(jcfg, jp, jnp.asarray(toks[:, :S]),
                            jnp.asarray(emb))
    lt, ct = model.prefill(cfg, tp, torch.from_numpy(toks[:, :S]).long(),
                           embeds=torch.from_numpy(emb))
    assert tuple(lt.shape) == (B, F + S, cfg.vocab_size)
    _close(lt, lj)
    _close(ct["A"]["k"], cj["A"]["k"])
    last, _ = model.prefill(cfg, tp, torch.from_numpy(toks[:, :S]).long(),
                            embeds=torch.from_numpy(emb), last_only=True)
    _close(last, lj[:, -1])
    cap = F + S + T
    cache_j = jmodel.seed_cache(jcfg, jmodel.init_cache(jcfg, B, cap), cj,
                                F + S)
    cache_t = model.seed_cache(cfg, model.init_cache(cfg, B, cap), ct, F + S)
    # the oracle: one prefill over embeds plus every token
    full, _ = model.prefill(cfg, tp, torch.from_numpy(toks).long(),
                            embeds=torch.from_numpy(emb))
    for t in range(T):
        nxt = toks[:, S + t:S + t + 1]
        pos = np.full(B, F + S + t, np.int32)
        dj, cache_j = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt),
                                         jnp.asarray(pos), cache_j)
        dt, cache_t = model.decode_step(cfg, tp, torch.from_numpy(nxt).long(),
                                        torch.from_numpy(pos), cache_t)
        _close(dt, dj)
        _close(dt, full[:, F + S + t], 2e-3)


def test_embeds_are_cast_and_packed_prefill_refuses_them():
    """``embeds`` is cast to the activation dtype before the concat, as the
    reference's ``embed_inputs``; a token-packed call takes none."""
    _, cfg, _, _ = _setup("phi3_vision_4_2b")
    cfg = cfg.with_(dtype="bfloat16", param_dtype="bfloat16")
    p = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    emb = torch.randn(1, 4, cfg.d_model, dtype=torch.float64)
    x = model.embed(cfg, p, torch.zeros((1, 3), dtype=torch.long), emb)
    assert x.dtype == torch.bfloat16 and tuple(x.shape[:2]) == (1, 7)
    assert torch.equal(x[:, :4], emb.to(torch.bfloat16))
    with pytest.raises(AssertionError, match="embeds"):
        model.prefill(cfg, p, torch.zeros((1, 3), dtype=torch.long),
                      embeds=emb, segment_ids=torch.zeros((1, 3),
                                                          dtype=torch.int32),
                      positions=torch.zeros((1, 3), dtype=torch.int32))
