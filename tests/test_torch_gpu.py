"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: run on a machine with an NVIDIA card (sm_90a, nvcc on
PATH or under CUDA_HOME) with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips with a reason; the decision is taken in a
fixture, never at import time."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.ref import POS_INVALID  # noqa: E402

pytestmark = pytest.mark.gpu

# (atol, rtol): both sides accumulate in float32; in bfloat16 each rounds
# its result once, so they may differ by one bf16 ulp (2**-7 relative)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2.0 ** -7)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_modes_match_plain(card, dtype, hd):
    g = card
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q, k, v = rnd(2, 150, 8, hd), rnd(2, 150, 2, hd), rnd(2, 150, 2, hd)
    before = flash_attention.launches
    _close(flash_attention(q, k, v), ref.flash_attention(q, k, v), dtype)
    seg = torch.repeat_interleave(torch.arange(3, device="cuda"),
                                  torch.tensor([40, 70, 40], device="cuda"))
    seg = seg[None].expand(2, 150).int()
    _close(flash_attention(q, k, v, segment_ids=seg, window=48),
           ref.flash_attention(q, k, v, segment_ids=seg, window=48), dtype)
    C, S = 64, 150
    slot = torch.arange(C, device="cuda")
    kpos = torch.cat([torch.where(slot < 30, slot, POS_INVALID),
                      30 + torch.arange(S, device="cuda")])[None]
    kpos = kpos.expand(2, C + S).int()
    qpos = (30 + torch.arange(S, device="cuda"))[None].expand(2, S).int()
    kk, vv = rnd(2, C + S, 2, hd), rnd(2, C + S, 2, hd)
    _close(flash_attention(q, kk, vv, q_positions=qpos, kv_positions=kpos,
                           softcap=30.0),
           ref.flash_attention(q, kk, vv, q_positions=qpos,
                               kv_positions=kpos, softcap=30.0), dtype)
    assert flash_attention.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_paged_decode_matches_plain(card, dtype, hd):
    g = card
    B, H, K, page, MP = 4, 16, 4, 16, 9
    P = B * MP + 2
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q, kp, vp = rnd(B, H, hd), rnd(P, page, K, hd), rnd(P, page, K, hd)
    bt = torch.randperm(P, generator=torch.Generator().manual_seed(0))[
        :B * MP].reshape(B, MP).int().cuda()
    cl = torch.tensor([0, 1, page, MP * page], dtype=torch.int32,
                      device="cuda")
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, bt, cl)
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, cl), dtype)
    assert torch.count_nonzero(got[0]) == 0          # ctx 0 gives zeros
    ck, cv = rnd(B, 96, K, hd), rnd(B, 96, K, hd)
    ctx = torch.tensor([5, 32, 33, 96], dtype=torch.int32, device="cuda")
    bt2 = (torch.arange(B)[:, None] * 3 + torch.arange(3)).int().cuda()
    _close(ops.decode_attention(q, ck, cv, ctx),
           ref.paged_decode_attention(q, ck.reshape(B * 3, 32, K, hd),
                                      cv.reshape(B * 3, 32, K, hd), bt2,
                                      ctx), dtype)
    assert paged_decode_attention.launches == before + 2


def test_wrappers_refuse_unsupported_inputs(card):
    q = torch.zeros(1, 16, 2, 48, device="cuda")          # hd 48
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half()[..., :32], q.half()[..., :32],
                        q.half()[..., :32])
