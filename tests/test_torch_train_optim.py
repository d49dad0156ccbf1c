"""The port's AdamW and checkpoints held against the reference's.

``apply_updates`` from the same params, grads and state as
``repro.training.optimizer.apply_updates``, over three steps inside the
warmup, with clipping active (gnorm > 1) and inactive: float32 params and
moments within 1e-6, ``state_dtype="bfloat16"`` moments bit-equal. A
checkpoint written by ``repro.training.checkpoint.save`` loads in the port
and one the port writes loads in the reference, with bf16 leaves and the
nested optimizer state."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.models.weights import (JAX_TO_PORT,  # noqa: E402
                                        params_from_jax)
from repro_torch.training import checkpoint, optimizer  # noqa: E402
from test_torch_train_model import one_torch_thread  # noqa: E402,F401

SHAPES = {"a": (64, 48), "b": (48,), "c": (300, 16), "d": (3, 40, 24)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(cfg_kw, grad_scales, param_dtype="float32"):
    """Three steps on both sides; yields (step, ref state, port state,
    ref gnorm, port gnorm, ref params, port params) after each."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
          for k, v in jp.items()}
    jcfg = jopt.AdamWConfig(**cfg_kw)
    cfg = optimizer.AdamWConfig(**cfg_kw)
    js, ts = jopt.init_state(jp, jcfg), optimizer.init_state(tp, cfg)
    for i, scale in enumerate(grad_scales):
        g = _tree(rng, scale)
        jp, js, jn = jopt.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        tp, ts, tn = optimizer.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, cfg)
        yield i, js, ts, float(jn), float(tn), jp, tp


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


# clipping active (gnorm ~ 40 against a clip of 1) then inactive, inside the
# 5-step warmup; and no clip at all
@pytest.mark.parametrize("clip,block", [(1.0, None), (0.0, None),
                                        (1.0, 100)],
                         ids=["clip", "no-clip", "clip-row-blocks"])
def test_float32_states_match(clip, block, monkeypatch):
    if block:       # large leaves updated a block of rows at a time
        monkeypatch.setattr(optimizer, "BLOCK", block)
    kw = dict(lr=1e-2, warmup_steps=5, grad_clip=clip)
    for i, js, ts, jn, tn, jp, tp in _run_both(kw, (2.0, 0.01, 1.0)):
        assert abs(tn - jn) <= 1e-6 * jn
        if clip and i == 0:
            assert jn > 1.0          # the clip binds on the first step
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in SHAPES:
            for name, a, b in (("m", ts["m"][k], js["m"][k]),
                               ("v", ts["v"][k], js["v"][k]),
                               ("p", tp[k], jp[k])):
                want = _f32(b)
                err = np.abs(_f32(a) - want).max()
                assert err <= 1e-6 * max(1.0, np.abs(want).max()), \
                    (i, name, k, err)


def _bits(a):
    return a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a).view(np.int16)


# The moments are bit-equal where the clip scale is exactly 1 (no clip, or a
# clip that does not bind): a binding clip divides by the global norm, whose
# float32 sum the two sides order differently (an ulp apart), and the
# float32 states above hold that case.
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,scales", [(0.0, (2.0, 0.01, 1.0)),
                                         (1.0, (0.005, 0.002, 0.008))],
                         ids=["no-clip", "clip-not-binding"])
def test_bfloat16_moments_equal_the_reference_bits(param_dtype, clip,
                                                   scales):
    kw = dict(lr=1e-2, warmup_steps=5, grad_clip=clip,
              state_dtype="bfloat16")
    for i, js, ts, jn, tn, jp, tp in _run_both(kw, scales, param_dtype):
        assert not clip or jn < clip
        for k in SHAPES:
            for a, b in ((ts["m"][k], js["m"][k]), (ts["v"][k], js["v"][k])):
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=f"{i} {k}")
            if param_dtype == "bfloat16":
                assert tp[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]),
                                              err_msg=f"{i} {k}")


def _ref_params(cfg):
    return {k: jnp.asarray(v, jnp.bfloat16) if k.endswith("norm1") else v
            for k, v in jmodel.init(cfg, jax.random.PRNGKey(0)).items()}


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    """Params with a bf16 leaf, a bf16-moment optimizer state and meta."""
    cfg = jax_config("stablelm_12b").reduced(layers=2, d_model=128).with_(
        param_dtype="float32", vocab_size=128)
    jp = _ref_params(cfg)
    js = jopt.init_state(jp, jopt.AdamWConfig(state_dtype="bfloat16"))
    js = {**js, "m": {k: (v + 0.5).astype(jnp.bfloat16)
                      for k, v in js["m"].items()}}
    path = str(tmp_path / "ref.msgpack")
    jckpt.save(path, jp, js, meta={"step": np.asarray(7)})
    got = checkpoint.load(path)
    assert int(got["__meta__"]["step"]) == 7
    assert set(got["params"]) == {JAX_TO_PORT[k] for k in jp}
    for k, v in jp.items():
        t = got["params"][JAX_TO_PORT[k]]
        assert t.dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_array_equal(t.float().numpy(), _f32(v))
        np.testing.assert_array_equal(
            got["opt_state"]["m"][JAX_TO_PORT[k]].float().numpy(),
            _f32(js["m"][k]))
    assert int(got["opt_state"]["step"]) == 0


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    cfg = jax_config("stablelm_12b").reduced(layers=2, d_model=128).with_(
        param_dtype="float32", vocab_size=128)
    jp = _ref_params(cfg)
    params = {k: v.to(torch.bfloat16) if k.endswith("attn_norm") else v
              for k, v in params_from_jax(
                  {k: np.asarray(v.astype(jnp.float32))
                   for k, v in jp.items()},
                  device="cpu", dtype=torch.float32).items()}
    state = optimizer.init_state(params, optimizer.AdamWConfig(
        state_dtype="bfloat16"))
    state["v"] = {k: v + 0.25 for k, v in state["v"].items()}
    path = str(tmp_path / "port.msgpack")
    checkpoint.save(path, params, state, meta={"step": 3})
    got = jckpt.load(path)
    assert int(got["__meta__"]["step"]) == 3
    assert set(got["params"]) == set(jp)
    for k, v in jp.items():
        a = got["params"][k]
        assert a.dtype == v.dtype
        np.testing.assert_array_equal(_f32(a), _f32(v))
        assert got["opt_state"]["v"][k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(_f32(got["opt_state"]["v"][k]), 0.25)
    back = checkpoint.load(path)
    for k, t in params.items():
        assert back["params"][k].dtype == t.dtype
        assert torch.equal(back["params"][k], t)
