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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,K", [(64, 16, 4), (128, 16, 4),
                                    (128, 16, 1)])
def test_paged_decode_split_edges(card, dtype, hd, H, K):
    """Contexts at the split boundaries +-1, ctx 0, and a row that ends in
    the first split beside a full one, through a block table and through
    the contiguous rows (no table); results repeat bit for bit. G = 4 and
    G = 16 (every row of the tensor-core tile a query head)."""
    from repro_torch.kernels.paged_attention import _sm_count, plan_splits
    g = card
    B, page, MP = 4, 16, 64
    cap = page * MP
    split, n_split = plan_splits(B, K, cap, _sm_count(0))
    assert n_split > 2
    P = B * MP + 2
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q, kp, vp = rnd(B, H, hd), rnd(P, page, K, hd), rnd(P, page, K, hd)
    bt = torch.randperm(P, generator=torch.Generator().manual_seed(1))[
        :B * MP].reshape(B, MP).int().cuda()
    ck, cv = rnd(B, cap, K, hd), rnd(B, cap, K, hd)
    ident = (torch.arange(B)[:, None] * (cap // 128)
             + torch.arange(cap // 128)).int().cuda()
    for ctx in ([0, split - 1, split, split + 1], [1, cap, 3, cap - 1],
                [2 * split + 1, 2 * split - 1, split * (n_split - 1), 0]):
        cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        n0 = (paged_decode_attention.launches,
              paged_decode_attention.combine_launches)
        got = paged_decode_attention(q, kp, vp, bt, cl)
        _close(got, ref.paged_decode_attention(q, kp, vp, bt, cl), dtype)
        assert torch.equal(got, paged_decode_attention(q, kp, vp, bt, cl))
        rows = ops.decode_attention(q, ck, cv, cl)
        _close(rows, ref.paged_decode_attention(
            q, ck.reshape(-1, 128, K, hd), cv.reshape(-1, 128, K, hd),
            ident, cl), dtype)
        assert (paged_decode_attention.launches,
                paged_decode_attention.combine_launches) == (n0[0] + 3,
                                                             n0[1] + 3)
        for b, c in enumerate(ctx):
            if c == 0:
                assert torch.count_nonzero(got[b]) == 0
                assert torch.count_nonzero(rows[b]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tile_edges(card, dtype):
    """Segments that cross tile edges, a chunk over a row that is mostly
    POS_INVALID, a window in positions mode, and rows that see no key
    (every tile skipped for them: they get the mean of V)."""
    g = card
    hd, H, K = 128, 8, 2
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    lens = (63, 2, 66, 129)
    S = sum(lens)
    seg = torch.repeat_interleave(torch.arange(4), torch.tensor(lens))
    seg = seg[None].int().cuda()
    q, k, v = rnd(1, S, H, hd), rnd(1, S, K, hd), rnd(1, S, K, hd)
    _close(flash_attention(q, k, v, segment_ids=seg),
           ref.flash_attention(q, k, v, segment_ids=seg), dtype)
    for C, S, plen, win in [(1024, 40, 5, None), (256, 100, 200, 64)]:
        slot = torch.arange(C, device="cuda")
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S, device="cuda")])[None]
        qpos = (plen + torch.arange(S, device="cuda"))[None].int()
        q, k, v = rnd(1, S, H, hd), rnd(1, C + S, K, hd), rnd(1, C + S, K, hd)
        kw = dict(q_positions=qpos, kv_positions=kpos.int(), window=win)
        _close(flash_attention(q, k, v, **kw),
               ref.flash_attention(q, k, v, **kw), dtype)
    Sq, Sk = 150, 200          # rows 0..99 precede every key
    qpos = torch.arange(Sq, device="cuda")[None].int()
    kpos = torch.where(torch.arange(Sk, device="cuda") < 30, POS_INVALID,
                       100 + torch.arange(Sk, device="cuda"))[None].int()
    q, k, v = rnd(1, Sq, H, hd), rnd(1, Sk, K, hd), rnd(1, Sk, K, hd)
    got = flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos)
    _close(got, ref.flash_attention(q, k, v, q_positions=qpos,
                                    kv_positions=kpos), dtype)


# --------------------------------------------------------------------- #
# KV migration and the fleet on the card
# --------------------------------------------------------------------- #
def _small_bf16():
    from repro_torch.configs import get_config
    return get_config("qwen3_8b").reduced()


def _requests(cfg, n, seed=0, lo=24, hi=160):
    import numpy as np
    from repro_torch.serving import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    return [GenRequest(
        prompt=[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(lo, hi)))],
        params=SamplingParams(max_new_tokens=int(rng.integers(6, 20))))
        for _ in range(n)]


def test_export_inject_roundtrip_is_bitwise_in_bf16(card):
    """The KV image is a byte copy: the target's cache row equals the
    source's, the CRC holds, and the target finishes the request."""
    from repro_torch.models.config import ATTN
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import kv_checksum
    cfg = _small_bf16()
    src = ServingEngine(cfg, max_batch=4, capacity=256, rl_accuracy=1.0)
    dst = ServingEngine(cfg, src.params, max_batch=4, capacity=256,
                        rl_accuracy=1.0, seed=1)
    g = _requests(cfg, 1)[0]
    t = 0.0
    src.submit(g, t)
    while not src.scheduler.gt_queue:
        t += 1.0
        src.step(t)
    slot = src.slot_of[g.rid]
    ctx = int(src._dev["pos"][slot])
    row = {n: src.caches[ATTN][n][:, slot, :ctx].clone() for n in ("k", "v")}
    payload = src.export_kv(g.rid)
    assert payload["ctx"] == ctx and src.n_export_reads == 1
    assert kv_checksum(payload["kv"]) == payload["kv_crc"]
    rid = dst.inject_kv(payload, t)
    for n in ("k", "v"):
        assert torch.equal(dst.caches[ATTN][n][:, dst.slot_of[rid], :ctx],
                           row[n])
    while dst.has_work() and t < 400:
        t += 1.0
        dst.step(t)
    dst.flush()
    assert g.status == "completed"
    assert len(g.output) == g.params.max_new_tokens


@pytest.mark.parametrize("roles", [None, ("prefill", "decode")],
                         ids=["unified", "disagg"])
def test_fleet_of_two_on_the_card(card, roles):
    from repro_torch.cluster import EngineFleet, check_fleet_invariants
    cfg = _small_bf16()
    fleet = EngineFleet(cfg, n_instances=2, roles=roles, seed=0,
                        max_batch=4, capacity=256, rl_accuracy=1.0)
    assert fleet.device.type == "cuda"
    paged_decode_attention.launches = 0
    reqs = fleet.run(_requests(cfg, 8))
    assert all(len(g.output) == g.params.max_new_tokens for g in reqs)
    assert fleet.conservation()["ok"]
    assert check_fleet_invariants(fleet)["ok"]
    iters = sum(i.engine.decode_iters for i in fleet.instances)
    assert paged_decode_attention.launches == cfg.num_layers * iters
    if roles is None:
        assert all(i.engine.scheduler.completed for i in fleet.instances)
    else:
        assert fleet.n_migrations == 8 and fleet.n_kv_fallbacks == 0
