"""The port's plain flash attention (what the prefill CUDA kernel
computes) held against the JAX oracle in ``repro.kernels.ref`` and the
Pallas kernel in interpret mode, on the sweeps of ``tests/test_kernels.py``.
Inputs are made with numpy from a seed and handed to both sides; bf16
inputs are rounded the same way on both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_prefill import (  # noqa: E402
    flash_attention as pallas_flash)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import POS_INVALID  # noqa: E402

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(
        np.array(a, np.float32)).to(TDT[dtype])


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def _ints(a):
    return jnp.asarray(a, jnp.int32), torch.from_numpy(
        np.asarray(a, np.int32))


def _flash_check(q, k, v, dtype, block, **masks):
    """Port plain version vs the JAX oracle and the Pallas kernel."""
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    jm, tm = {}, {}
    for name, a in masks.items():
        if a is None or name in ("window", "softcap"):
            jm[name] = tm[name] = a
        else:
            jm[name], tm[name] = _ints(a)
    got = ops.flash_attention(
        tq, tk, tv, tm.get("segment_ids"), tm.get("q_positions"),
        tm.get("kv_positions"), tm.get("kv_segment_ids"),
        window=tm.get("window"), softcap=tm.get("softcap"))
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    _close(got, jref.flash_attention(jq, jk, jv, causal=True, **jm), dtype)
    _close(got, pallas_flash(jq, jk, jv, causal=True, block_q=block,
                             block_k=block, interpret=True, **jm), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,win,cap", [
    (2, 256, 4, 2, 64, None, None),
    (1, 200, 8, 8, 128, None, None),
    (2, 384, 4, 1, 64, 128, None),
    (1, 256, 2, 2, 64, None, 30.0),
    (1, 130, 6, 3, 32, 64, None),
])
def test_flash_implicit_matches_jax(B, S, H, K, hd, win, cap, dtype):
    rng = np.random.default_rng(0)
    _flash_check(rng.standard_normal((B, S, H, hd)),
                 rng.standard_normal((B, S, K, hd)),
                 rng.standard_normal((B, S, K, hd)), dtype, 64,
                 window=win, softcap=cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seg_lens,win,cap", [
    ((48, 80), None, None),
    ((17, 60, 51), None, 30.0),
    ((100, 28), 32, None),
    ((5, 3, 90, 30), None, None),
])
def test_flash_segments_match_jax(seg_lens, win, cap, dtype):
    rng = np.random.default_rng(3)
    S = sum(seg_lens)
    seg = np.repeat(np.arange(len(seg_lens)), seg_lens)[None]
    _flash_check(rng.standard_normal((1, S, 4, 32)),
                 rng.standard_normal((1, S, 2, 32)),
                 rng.standard_normal((1, S, 2, 32)), dtype, 64,
                 window=win, softcap=cap, segment_ids=seg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,S,plen,win,cap", [
    (64, 48, 40, None, None),
    (96, 17, 60, None, 30.0),
    (128, 33, 100, 48, None),
    (64, 48, 0, None, None),
])
def test_flash_prefix_positions_match_jax(C, S, plen, win, cap, dtype):
    rng = np.random.default_rng(5)
    B = 2
    slot = np.arange(C)
    qpos = np.broadcast_to(plen + np.arange(S), (B, S))
    kpos = np.broadcast_to(np.concatenate(
        [np.where(slot < plen, slot, POS_INVALID), plen + np.arange(S)]),
        (B, C + S))
    _flash_check(rng.standard_normal((B, S, 4, 32)),
                 rng.standard_normal((B, C + S, 2, 32)),
                 rng.standard_normal((B, C + S, 2, 32)), dtype, 64,
                 window=win, softcap=cap, q_positions=qpos,
                 kv_positions=kpos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Cp,spans,win,cap", [
    (64, ((40, 24), (0, 30)), None, None),
    (64, ((60, 17), (32, 33), (5, 8)), None, 30.0),
    (96, ((90, 20), (48, 40)), 64, None),
])
def test_flash_packed_chunks_match_jax(Cp, spans, win, cap, dtype):
    rng = np.random.default_rng(11)
    n = len(spans)
    T = sum(L for _, L in spans)
    qpos, qseg, ppos, pseg = [], [], [], []
    for i, (start, L) in enumerate(spans):
        qpos.append(start + np.arange(L))
        qseg.append(np.full(L, i))
        slot = np.arange(Cp)
        ppos.append(np.where(slot < start, slot, POS_INVALID))
        pseg.append(np.full(Cp, i))
    qpos, qseg = np.concatenate(qpos)[None], np.concatenate(qseg)[None]
    kpos = np.concatenate(ppos + [qpos[0]])[None]
    kseg = np.concatenate(pseg + [qseg[0]])[None]
    _flash_check(rng.standard_normal((1, T, 4, 32)),
                 rng.standard_normal((1, n * Cp + T, 2, 32)),
                 rng.standard_normal((1, n * Cp + T, 2, 32)), dtype, 64,
                 window=win, softcap=cap, segment_ids=qseg,
                 kv_segment_ids=kseg, q_positions=qpos, kv_positions=kpos)


def test_wrappers_refuse_inputs_that_require_grad():
    """The kernels have no backward: each wrapper raises for an input that
    requires grad (on the CPU too, where it would run the plain version),
    and runs under ``torch.no_grad`` or on detached inputs."""
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import (decode_rows,
                                                     paged_decode_attention)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 2, 32, generator=g, requires_grad=True)
    rows = torch.randn(1, 16, 2, 32, generator=g)
    lens = torch.tensor([16], dtype=torch.int32)
    bt = torch.zeros((1, 1), dtype=torch.int32)
    calls = {"flash_attention": lambda a: flash_attention(a, a, a),
             "paged_decode_attention": lambda a: paged_decode_attention(
                 a[:, 0], rows, rows, bt, lens),
             "decode_rows": lambda a: decode_rows(a[:, 0], rows, rows, lens,
                                                  16)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call(q)
        with torch.no_grad():
            call(q)
        assert not call(q.detach()).requires_grad
