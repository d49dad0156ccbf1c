"""Both kernels' plain versions at the head dims the configs use beyond
32/64/128 (96: phi3-vision, 112: zamba2-7b, 160: stablelm-12b), with
G = 1 (one query head per kv head, MHA: zamba2's shared block, opt-13b)
and G = 4, held against the Pallas kernels in interpret mode and the JAX
oracles; and every attention config's head dim is one the CUDA kernels
are built for."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as pallas_paged)
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import flash_prefill, ops  # noqa: E402
from repro_torch.kernels import paged_attention  # noqa: E402
from repro_torch.kernels.ref import POS_INVALID  # noqa: E402

from test_torch_kernels import _flash_check  # noqa: E402
from test_torch_kernels_decode import (_close, _ints, _paged_inputs,  # noqa
                                       _pair)

HEAD_DIMS = (96, 112, 160)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("H,K", [(2, 2), (4, 1)], ids=["G1", "G4"])
def test_flash_causal_head_dims_match_jax(hd, H, K, dtype):
    """Implicit causal mode (zamba2's exact prefill) across a tile edge."""
    rng = np.random.default_rng(hd + H)
    S = 130
    _flash_check(rng.standard_normal((1, S, H, hd)),
                 rng.standard_normal((1, S, K, hd)),
                 rng.standard_normal((1, S, K, hd)), dtype, 64)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_positions_head_dims_match_jax(hd):
    """A chunk over a cache prefix (explicit positions), G = 1."""
    rng = np.random.default_rng(hd)
    C, S, plen = 64, 33, 40
    slot = np.arange(C)
    qpos = (plen + np.arange(S))[None]
    kpos = np.concatenate([np.where(slot < plen, slot, POS_INVALID),
                           plen + np.arange(S)])[None]
    _flash_check(rng.standard_normal((1, S, 2, hd)),
                 rng.standard_normal((1, C + S, 2, hd)),
                 rng.standard_normal((1, C + S, 2, hd)), "float32", 64,
                 q_positions=qpos, kv_positions=kpos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("H,K", [(3, 3), (8, 2)], ids=["G1", "G4"])
def test_paged_decode_head_dims_match_jax(hd, H, K, dtype):
    """Contexts 1, a page edge, a page edge + 1 and full; and ctx 0, which
    gives zeros like the Pallas kernel."""
    B, page, MP = 5, 16, 4
    q, kp, vp, bt, _ = _paged_inputs(B, H, K, hd, page, MP, hd + H)
    cl = np.asarray([1, page, page + 1, MP * page, 0], np.int32)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    jbt, tbt = _ints(bt)
    jcl, tcl = _ints(cl)
    got = ops.paged_decode_attention(tq, tk, tv, tbt, tcl)
    _close(got, pallas_paged(jq, jk, jv, jbt, jcl, interpret=True), dtype)
    _close(got[:4], jref.paged_decode_attention(jq, jk, jv, jbt, jcl)[:4],
           dtype)
    assert not got[4].any()
    rows = ops.decode_attention(
        tq, tk[tbt.long()].reshape(B, MP * page, K, hd),
        tv[tbt.long()].reshape(B, MP * page, K, hd), tcl)
    assert torch.equal(rows, got)


def test_every_config_head_dim_has_a_kernel():
    """Each config with attention (its own layers or a shared block) has a
    head dim both CUDA kernels are instantiated for."""
    dims = {get_config(a).resolved_head_dim for a in list_archs()
            if get_config(a).has_attention}
    assert dims == {64, 96, 112, 128, 160}
    for wrapper in (flash_prefill, paged_attention):
        assert dims <= set(wrapper._HEAD_DIMS)
