"""The port's training forward held against the reference's, float32, on
the same weights (``params_from_jax``) and the same ``SyntheticDataset``
batch: the loss of ``make_loss_fn`` (text positions, plus the MoE aux), the
aux loss, and every gradient (``params_to_jax(grads)`` against
``jax.grad``), for the reduced attention families with remat on both sides
(the recurrent ones in ``test_torch_train_recurrent.py``, the streaming
flash attention in ``test_torch_train_flash.py``). Loss to 1e-5 relative;
each gradient leaf to 1e-4 * max|g_ref| + 1e-7."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.training import train_loop as jtrain  # noqa: E402
from repro.training.data import DataConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, model, moe  # noqa: E402
from repro_torch.models.weights import (params_from_jax,  # noqa: E402
                                        params_to_jax)
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.data import SyntheticDataset  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32", remat=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process. The suite runs in parallel
    workers, and a pool of one thread per core in each oversubscribes the
    CPU: the many small ops of a training step then wait on each other's
    barriers (test_loss_decreases_dense took 246 s under the full suite
    against 1.5 s alone). One thread is as fast alone at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, reduce=None):
    red = lambda c: c.reduced(**(reduce or {})).with_(**F32)
    return red(jax_config(arch)), red(get_config(arch))


def batch_of(cfg, B, S, seed=0):
    F = cfg.frontend_tokens if cfg.frontend else 0
    return next(SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=seed,
        frontend_tokens=F, d_model=cfg.d_model)).batches())


def both(jcfg, cfg, B, S):
    """(ref loss, aux, grads by path), (port loss, aux, grads by path)."""
    flat = jmodel.init(jcfg, jax.random.PRNGKey(0))
    batch = batch_of(cfg, B, S)
    (jloss, jaux), jgrads = jax.value_and_grad(
        jtrain.make_loss_fn(jcfg), has_aux=True)(
        flat, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax({k: np.asarray(v) for k, v in flat.items()},
                             device="cpu", dtype=torch.float32)
    for p in params.values():
        p.requires_grad_(True)
    tb = train_loop.batch_to(batch, cfg, "cpu")
    loss, aux = train_loop.make_loss_fn(cfg)(params, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    return ((float(jloss), float(jaux), {k: np.asarray(v)
                                          for k, v in jgrads.items()}),
            (float(loss.detach()), float(aux.detach()),
             params_to_jax(dict(zip(params, grads)))))


def assert_close(ref, got):
    (jl, ja, jg), (l, a, g) = ref, got
    assert abs(l - jl) <= 1e-5 * abs(jl), (l, jl)
    assert abs(a - ja) <= 1e-5 * abs(ja) + 1e-7, (a, ja)
    assert set(g) == set(jg)
    for k in jg:
        tol = 1e-4 * float(np.abs(jg[k]).max()) + 1e-7
        err = float(np.abs(g[k] - jg[k]).max())
        assert err <= tol, (k, err, tol)


# dense GQA, MoE (aux nonzero), frontend embeds, a sliding window (64),
# and MoE at capacity factor 0.5, where the reference's router sends more
# of the 192 tokens' assignments to an expert than its 48 slots in every
# layer: the backward pass runs through dropped assignments (the
# dispatch's cut-off column, the combine's zero rows); arctic's MoE has a
# dense residual FFN beside it
@pytest.mark.parametrize("arch,cf", [
    ("qwen3_8b", None), ("phi3_5_moe_42b", None), ("phi3_vision_4_2b", None),
    ("mistral_nemo_12b", None), ("phi3_5_moe_42b", 0.5),
    ("arctic_480b", None)],
    ids=["qwen3_8b", "phi3_5_moe_42b", "phi3_vision_4_2b",
         "mistral_nemo_12b", "phi3_5_moe_42b-drops", "arctic_480b"])
def test_loss_aux_and_every_grad_match_the_reference(arch, cf, monkeypatch):
    jcfg, cfg = cfgs(arch)
    if cf is not None:
        jcfg, cfg = jcfg.with_(capacity_factor=cf), cfg.with_(
            capacity_factor=cf)
    seen, apply = [], moe.moe_apply

    def recorded(p, c, x, rows=None):
        seen.append((p["router"].detach().numpy(), x.detach().numpy()))
        return apply(p, c, x, rows)

    monkeypatch.setattr(moe, "moe_apply", recorded)
    ref, got = both(jcfg, cfg, 2, 96)
    assert_close(ref, got)
    if cfg.is_moe:
        assert ref[1] > 0
    if cf is not None:
        from test_torch_moe import _expert_loads
        C = jmoe.capacity(jcfg, 2 * 96)
        assert C == moe.capacity(cfg, 2 * 96) == 48
        assert len(seen) >= cfg.num_layers
        for router, x in seen[:cfg.num_layers]:   # the forward's calls
            loads = _expert_loads({"router": jnp.asarray(router)}, x,
                                  cfg.experts_per_token)
            assert loads.max() > C, loads


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each layer (and the shared block) in the
    backward pass; the gradients are the same numbers as without it."""
    _, cfg = cfgs("zamba2_7b", dict(layers=4))
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tb = train_loop.batch_to(batch_of(cfg, 2, 48), cfg, "cpu")
    out = []
    for remat in (True, False):
        c = cfg.with_(remat=remat)
        leaves = {k: p.detach().clone().requires_grad_(True)
                  for k, p in params.items()}
        loss, _ = train_loop.make_loss_fn(c)(leaves, tb)
        out.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_forward_train_launches_no_kernel(monkeypatch):
    """The training forward reaches neither kernel wrapper."""
    from repro_torch.kernels import flash_prefill, paged_attention

    def refuse(*a, **k):
        raise AssertionError("forward_train called a kernel wrapper")

    for mod, name in ((flash_prefill, "flash_attention"),
                      (paged_attention, "paged_decode_attention"),
                      (paged_attention, "decode_rows")):
        monkeypatch.setattr(mod, name, refuse)
    for name in ("_flash", "_paged", "_decode_rows"):
        monkeypatch.setattr(attention.ops, name, refuse)
    _, cfg = cfgs("zamba2_7b", dict(layers=4))
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, aux = model.forward_train(
        cfg, params, torch.zeros((1, 2100), dtype=torch.long))
    assert logits.shape == (1, 2100, cfg.vocab_size)
    assert torch.isfinite(logits).all() and float(aux) == 0.0
