"""The port's plain decode attention (what the paged CUDA kernel computes)
and its contiguous-row and page-append helpers held against the JAX oracles
in ``repro.kernels.ref`` and the Pallas kernel in interpret mode, on the
sweeps of ``tests/test_kernels.py``. Inputs are made with numpy from a seed
and handed to both sides; bf16 inputs are rounded the same way on both
sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as pallas_paged)
from repro_torch.kernels import ops, ref  # noqa: E402

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


def _paged_inputs(B, H, K, hd, page, MP, seed):
    rng = np.random.default_rng(seed)
    P = B * MP + 3
    q = rng.standard_normal((B, H, hd))
    kp = rng.standard_normal((P, page, K, hd))
    vp = rng.standard_normal((P, page, K, hd))
    bt = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    return q, kp, vp, bt, rng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,hd,page,MP", [
    (3, 8, 2, 64, 16, 5),
    (2, 4, 4, 128, 32, 4),
    (1, 8, 1, 64, 8, 7),
    (4, 2, 2, 32, 16, 3),
])
def test_paged_decode_matches_jax(B, H, K, hd, page, MP, dtype):
    q, kp, vp, bt, rng = _paged_inputs(B, H, K, hd, page, MP, 1)
    cl = rng.integers(1, MP * page, B).astype(np.int32)   # ctx 0 excluded
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    jbt, tbt = _ints(bt)
    jcl, tcl = _ints(cl)
    got = ops.paged_decode_attention(tq, tk, tv, tbt, tcl)
    _close(got, jref.paged_decode_attention(jq, jk, jv, jbt, jcl), dtype)
    _close(got, pallas_paged(jq, jk, jv, jbt, jcl, interpret=True), dtype)


@pytest.mark.parametrize("softcap,cl", [
    (None, (1, 5)),            # inside the first page
    (25.0, (50, 90)),          # GQA + softcap, several pages
    (None, (96, 96)),          # context == max_pages * page
])
def test_paged_decode_context_edges(softcap, cl):
    B, H, K, hd, page, MP = 2, 8, 2, 64, 16, 6
    q, kp, vp, bt, _ = _paged_inputs(B, H, K, hd, page, MP, 4)
    cl = np.asarray(cl, np.int32)
    jq, tq = _pair(q, "float32")
    jk, tk = _pair(kp, "float32")
    jv, tv = _pair(vp, "float32")
    jbt, tbt = _ints(bt)
    jcl, tcl = _ints(cl)
    got = ops.paged_decode_attention(tq, tk, tv, tbt, tcl, softcap=softcap)
    _close(got, jref.paged_decode_attention(jq, jk, jv, jbt, jcl,
                                            softcap=softcap), "float32")
    _close(got, pallas_paged(jq, jk, jv, jbt, jcl, softcap=softcap,
                             pages_per_step=4, interpret=True), "float32")


def test_paged_decode_context_zero_is_zeros_like_the_kernel():
    """ctx 0: the Pallas kernel (and so the port) gives zeros, where the
    JAX oracle gives the mean of V; the port follows the kernel."""
    q, kp, vp, bt, _ = _paged_inputs(2, 4, 2, 32, 8, 3, 6)
    cl = np.asarray([0, 11], np.int32)
    jq, tq = _pair(q, "float32")
    jk, tk = _pair(kp, "float32")
    jv, tv = _pair(vp, "float32")
    jbt, tbt = _ints(bt)
    jcl, tcl = _ints(cl)
    got = ops.paged_decode_attention(tq, tk, tv, tbt, tcl)
    assert torch.count_nonzero(got[0]) == 0
    _close(got, pallas_paged(jq, jk, jv, jbt, jcl, interpret=True),
           "float32")


@pytest.mark.parametrize("C,page", [(96, 32), (2048, 128), (100, 100)])
def test_decode_attention_contiguous_wrapper(C, page):
    """Rows viewed as pages of the largest of 128/64/32/16/8 dividing C
    (else C) under an identity block table."""
    assert ops.page_size(C) == page
    B, K, hd, H = 2, 2, 64, 4
    rng = np.random.default_rng(2)
    q, ck, cv = (rng.standard_normal(s) for s in
                 ((B, H, hd), (B, C, K, hd), (B, C, K, hd)))
    ctx = np.asarray([C // 3, C], np.int32)
    jq, tq = _pair(q, "float32")
    jk, tk = _pair(ck, "float32")
    jv, tv = _pair(cv, "float32")
    jc, tc = _ints(ctx)
    got = ops.decode_attention(tq, tk, tv, tc)
    mp = C // page
    bt = (np.arange(B)[:, None] * mp + np.arange(mp)[None]).astype(np.int32)
    want = jref.paged_decode_attention(
        jq, jk.reshape(B * mp, page, K, hd), jv.reshape(B * mp, page, K, hd),
        jnp.asarray(bt), jc)
    _close(got, want, "float32")


def test_kv_page_append_roundtrip():
    B, page, K, hd, MP = 2, 8, 2, 16, 3
    P = B * MP
    kp = torch.zeros(P, page, K, hd)
    vp = torch.zeros(P, page, K, hd)
    bt = torch.arange(P, dtype=torch.int32).reshape(B, MP)
    k_new = torch.ones(B, K, hd)
    pos = torch.tensor([0, 13], dtype=torch.int32)
    kp2, vp2 = ref.kv_page_append(kp, vp, k_new, k_new * 2, bt, pos)
    assert float(kp2[bt[0, 0], 0].sum()) == K * hd
    assert float(kp2[bt[1, 1], 5].sum()) == K * hd
    assert float(vp2[bt[1, 1], 5].sum()) == 2 * K * hd
    # the same scatter as the JAX oracle
    jk, jv = jref.kv_page_append(jnp.zeros((P, page, K, hd)),
                                 jnp.zeros((P, page, K, hd)),
                                 jnp.ones((B, K, hd)),
                                 2 * jnp.ones((B, K, hd)),
                                 jnp.asarray(bt.numpy()),
                                 jnp.asarray(pos.numpy()))
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(jv))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused: no
    fallback to the plain version."""
    q = torch.empty(1, 16, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention(torch.empty(1, 2, 32, device="meta"),
                             q[:, :, :1], q[:, :, :1],
                             torch.ones(1, dtype=torch.int32, device="meta"))
