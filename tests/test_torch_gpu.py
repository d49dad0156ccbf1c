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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 112, 160])
@pytest.mark.parametrize("H,K", [(4, 4), (16, 4)], ids=["G1", "G4"])
def test_new_head_dims_match_plain(card, dtype, hd, H, K):
    """hd 96, 112 and 160 (phi3-vision, zamba2-7b, stablelm-12b) with
    G = 1 (MHA: 15 of the decode kernel's 16 MMA rows empty) and G = 4:
    flash in causal mode (zamba2's exact prefill) across tile edges and
    over a cache prefix; decode at ctx 0, 1, page edges and full, through a
    block table and through contiguous rows."""
    g = card
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q, k, v = rnd(1, 193, H, hd), rnd(1, 193, K, hd), rnd(1, 193, K, hd)
    _close(flash_attention(q, k, v), ref.flash_attention(q, k, v), dtype)
    C, S = 128, 70
    slot = torch.arange(C, device="cuda")
    kpos = torch.cat([torch.where(slot < 65, slot, POS_INVALID),
                      65 + torch.arange(S, device="cuda")])[None].int()
    qpos = (65 + torch.arange(S, device="cuda"))[None].int()
    q, k, v = rnd(1, S, H, hd), rnd(1, C + S, K, hd), rnd(1, C + S, K, hd)
    _close(flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos),
           ref.flash_attention(q, k, v, q_positions=qpos,
                               kv_positions=kpos), dtype)
    B, page, MP = 5, 16, 9
    P = B * MP + 2
    q, kp, vp = rnd(B, H, hd), rnd(P, page, K, hd), rnd(P, page, K, hd)
    bt = torch.randperm(P, generator=torch.Generator().manual_seed(2))[
        :B * MP].reshape(B, MP).int().cuda()
    cl = torch.tensor([0, 1, page, page + 1, MP * page], dtype=torch.int32,
                      device="cuda")
    got = paged_decode_attention(q, kp, vp, bt, cl)
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, cl), dtype)
    assert torch.count_nonzero(got[0]) == 0
    rows = ops.decode_attention(q, kp[bt.long()].reshape(B, -1, K, hd),
                                vp[bt.long()].reshape(B, -1, K, hd), cl)
    _close(rows, got, dtype)


def test_zamba2_engine_on_the_card_matches_the_cpu(card):
    """zamba2-7b reduced in float32 (TF32 off): the engine on the card
    (both kernels at G = 1 in the shared block, Mamba2 elsewhere, chunks
    recomputed) gives the CPU engine's greedy streams, completion times
    and counters on the same weights."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import model
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine
    cfg = get_config("zamba2_7b").reduced().with_(dtype="float32",
                                                  param_dtype="float32")
    scfg = dict(kvc_tokens=4 * 192, block_size=16, tfs=48,
                max_model_len=192, max_batch_reqs=4)

    def run(device, params=None):
        eng = ServingEngine(cfg, params, max_batch=4, capacity=192,
                            rl_accuracy=1.0, device=device,
                            scheduler_cfg=SchedulerConfig(**scfg))
        rng = np.random.default_rng(3)
        reqs = [GenRequest(prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(8, 120)))],
            params=SamplingParams(max_new_tokens=int(rng.integers(6, 30))))
            for _ in range(6)]
        eng.run(reqs)
        return eng, [(g.output, g.t_done) for g in reqs]

    flash_attention.launches = paged_decode_attention.launches = 0
    gpu, got = run("cuda")
    assert flash_attention.launches > 0
    assert paged_decode_attention.launches == \
        model.num_shared_invocations(cfg) * gpu.decode_iters
    cpu, want = run("cpu", {k: t.cpu() for k, t in gpu.params.items()})
    assert got == want
    assert gpu.n_prefill_chunks == cpu.n_prefill_chunks > 0
    assert gpu.sync_counts == cpu.sync_counts


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "mistral_nemo_12b"],
                         ids=["moe", "ring"])
def test_moe_and_ring_engines_on_the_card_match_the_cpu(card, arch):
    """phi3.5-MoE reduced (padded MoE calls) and mistral-nemo reduced with
    a 64-token window (ring caches: prompts past the window, decode
    wrapping, recomputed chunks), float32, TF32 off: the engine on the
    card gives the CPU engine's greedy streams, completion times and
    counters on the same weights."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models.config import ATTN
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine
    cfg = get_config(arch).reduced().with_(dtype="float32",
                                           param_dtype="float32")
    lo, hi = 8, 120
    if arch == "mistral_nemo_12b":
        cfg, lo, hi = cfg.with_(sliding_window=64), 70, 150
    scfg = dict(kvc_tokens=4 * 192, block_size=16, tfs=48,
                max_model_len=192, max_batch_reqs=4)

    def run(device, params=None):
        eng = ServingEngine(cfg, params, max_batch=4, capacity=192,
                            rl_accuracy=1.0, device=device,
                            scheduler_cfg=SchedulerConfig(**scfg))
        rng = np.random.default_rng(3)
        reqs = [GenRequest(prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(lo, hi)))],
            params=SamplingParams(max_new_tokens=int(rng.integers(6, 30))))
            for _ in range(6)]
        eng.run(reqs)
        return eng, [(g.output, g.t_done) for g in reqs]

    flash_attention.launches = paged_decode_attention.launches = 0
    gpu, got = run("cuda")
    assert flash_attention.launches > 0
    assert paged_decode_attention.launches == cfg.num_layers * \
        gpu.decode_iters
    cpu, want = run("cpu", {k: t.cpu() for k, t in gpu.params.items()})
    assert got == want
    assert gpu.n_prefill_chunks == cpu.n_prefill_chunks > 0
    assert gpu.sync_counts == cpu.sync_counts
    assert gpu._is_ring(ATTN) == (cfg.sliding_window is not None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["window-prefill", "ring-decode",
                                  "vision-prefill"])
def test_new_serving_shapes_match_plain(card, dtype, case):
    """The shapes this slice's serving paths give the kernels:
    mistral-nemo's prefill of a 10240-token prompt under its 8192 window
    (G = 4), decode over four full 8192-slot rings (H 32, K 8), and
    phi3-vision's causal prefill of 1024 patches and 128 tokens (MHA at
    hd 96, B = 2)."""
    g = card
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    if case == "ring-decode":
        B, C, H, K, hd = 4, 8192, 32, 8, 128
        q, ck, cv = rnd(B, H, hd), rnd(B, C, K, hd), rnd(B, C, K, hd)
        ctx = torch.full((B,), C, dtype=torch.int32, device="cuda")
        ps = ops.page_size(C)
        bt = torch.arange(B * C // ps, device="cuda").reshape(B, -1).int()
        want = ref.paged_decode_attention(q, ck.view(-1, ps, K, hd),
                                          cv.view(-1, ps, K, hd), bt, ctx)
        _close(ops.decode_attention(q, ck, cv, ctx), want, dtype)
        return
    if case == "window-prefill":
        shape_q, shape_kv, kw = (1, 10240, 32, 128), (1, 10240, 8, 128), \
            dict(window=8192)
    else:
        shape_q = shape_kv = (2, 1152, 32, 96)
        kw = {}
    q, k, v = rnd(*shape_q), rnd(*shape_kv), rnd(*shape_kv)
    _close(flash_attention(q, k, v, **kw), ref.flash_attention(q, k, v, **kw),
           dtype)


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
    G = 16 (every column of S^T a query head). The splits are the plan's
    (``paged_attention.plan``), the same for both layouts."""
    from repro_torch.kernels.paged_attention import _sm_count, plan
    g = card
    B, page, MP = 4, 16, 64
    cap = page * MP
    p = plan(B, H, K, hd, cap, page, _sm_count(0))
    split, n_split = p["split"], p["n_split"]
    assert n_split > 2
    assert (split, n_split) == (plan(B, H, K, hd, cap, cap, _sm_count(0))[
        "split"], plan(B, H, K, hd, cap, cap, _sm_count(0))["n_split"])
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
        n0 = paged_decode_attention.launches
        got = paged_decode_attention(q, kp, vp, bt, cl)
        _close(got, ref.paged_decode_attention(q, kp, vp, bt, cl), dtype)
        assert torch.equal(got, paged_decode_attention(q, kp, vp, bt, cl))
        rows = ops.decode_attention(q, ck, cv, cl)
        _close(rows, ref.paged_decode_attention(
            q, ck.reshape(-1, 128, K, hd), cv.reshape(-1, 128, K, hd),
            ident, cl), dtype)
        assert paged_decode_attention.launches == n0 + 3
        for b, c in enumerate(ctx):
            if c == 0:
                assert torch.count_nonzero(got[b]) == 0
                assert torch.count_nonzero(rows[b]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,K,page", [
    (64, 16, 4, 8), (64, 16, 4, 16), (128, 16, 4, 8), (128, 16, 4, 16),
    (160, 4, 4, 32), (160, 4, 4, 16), (64, 32, 4, 1), (64, 16, 4, 4),
    (128, 16, 4, 12), (128, 16, 2, 20), (160, 4, 4, 36), (160, 16, 4, 12),
    (128, 8, 8, 4)],
    ids=["hd64-G4-page8", "hd64-G4-page16", "hd128-G4-page8",
         "hd128-G4-page16", "hd160-G1-page32", "hd160-G1-page16",
         "hd64-G8-page1", "hd64-G4-page4", "hd128-G4-page12",
         "hd128-G8-page20", "hd160-G1-page36", "hd160-G4-page12",
         "hd128-G1-page4"])
def test_paged_decode_pages_under_a_tile(card, dtype, hd, H, K, page):
    """Pages smaller than the bf16 kernel's 64-key tile: a multiple of 8
    slots (one TMA box a page, all completing on the tile's barrier), or
    not (1-36 slots: the cp.async copy, a key row at a time), and hd 160
    (three 64-column boxes, the last half zero-filled) at G = 1 and 4:
    contexts on each split edge +-1, inside a page, ctx 0 and full,
    against the plain version and against contiguous rows; bit-equal on
    repeat, one launch a call. A softcap on the last call."""
    from repro_torch.kernels.paged_attention import _sm_count, plan
    g = card
    B, MP = 4, 512 // page
    cap = page * MP
    p = plan(B, H, K, hd, cap, page, _sm_count(0))
    split, n_split = p["split"], p["n_split"]
    if page % 8:
        assert p["copy"] == "cp.async"
    else:
        assert p["copy"] == "tma" and p["box"] == min(page, 64)
    P = B * MP + 3
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q, kp, vp = rnd(B, H, hd), rnd(P, page, K, hd), rnd(P, page, K, hd)
    bt = torch.randperm(P, generator=torch.Generator().manual_seed(2))[
        :B * MP].reshape(B, MP).int().cuda()
    rows_k = kp[bt.long()].reshape(B, cap, K, hd)
    rows_v = vp[bt.long()].reshape(B, cap, K, hd)
    edges = sorted({c for e in range(1, n_split)
                    for c in (e * split - 1, e * split, e * split + 1)
                    if 0 < c <= cap} | {0, 1, page - 1, page + 3, cap})
    for i in range(0, len(edges), B):
        ctx = [edges[(i + j) % len(edges)] for j in range(B)]
        cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        soft = 20.0 if i + B >= len(edges) else None
        want = ref.paged_decode_attention(q, kp, vp, bt, cl, softcap=soft)
        n0 = paged_decode_attention.launches
        got = paged_decode_attention(q, kp, vp, bt, cl, softcap=soft)
        _close(got, want, dtype)
        assert torch.equal(got, paged_decode_attention(q, kp, vp, bt, cl,
                                                       softcap=soft))
        _close(ops.decode_attention(q, rows_k, rows_v, cl, softcap=soft),
               want, dtype)
        assert paged_decode_attention.launches == n0 + 3
        for b, c in enumerate(ctx):
            if c == 0:
                assert torch.count_nonzero(got[b]) == 0


@pytest.mark.parametrize("G", [2, 3, 5, 6, 7, 8, 9, 12, 16])
def test_paged_decode_every_group_size(card, G):
    """Query heads a kv head beyond the G = 1 and 4 of the configs: the
    bf16 kernel's three builds (up to 4, 8 and 16 heads) at every size
    between, with padded S^T and O^T columns, against the plain version;
    float32 beside. Two kv heads, a softcap, contexts 0, 1, a page edge,
    a split edge and full."""
    from repro_torch.kernels.paged_attention import _sm_count, plan
    g = card
    B, K, hd, page, MP = 5, 2, 64, 16, 40
    cap = page * MP
    split = plan(B, G * K, K, hd, cap, page, _sm_count(0))["split"]
    P = B * MP + 1
    bt = torch.randperm(P, generator=torch.Generator().manual_seed(3))[
        :B * MP].reshape(B, MP).int().cuda()
    cl = torch.tensor([0, 1, page + 1, split + 1, cap], dtype=torch.int32,
                      device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g,
                                     device="cuda").to(dtype)
        q, kp, vp = rnd(B, G * K, hd), rnd(P, page, K, hd), rnd(P, page, K,
                                                                 hd)
        got = paged_decode_attention(q, kp, vp, bt, cl, softcap=30.0)
        _close(got, ref.paged_decode_attention(q, kp, vp, bt, cl,
                                               softcap=30.0), dtype)
        assert torch.count_nonzero(got[0]) == 0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_wgmma_tile_edges(card, dtype, block_q, monkeypatch):
    """The bf16 kernel's 64- and 128-row tiles (forced through the plan, so
    that small calls reach both): segments across a 128-row edge, Sq and
    Sk not multiples of 128 (positions, with and without a window), and hd
    112 and 160, whose last 64-wide TMA box is partial, causal and over a
    prefix."""
    import functools
    from repro_torch.kernels import flash_prefill as fp
    monkeypatch.setattr(fp, "plan", functools.partial(fp.plan,
                                                      block_q=block_q))
    g = card
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)

    def prefix(C, S, plen):
        slot = torch.arange(C, device="cuda")
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S, device="cuda")])[None]
        return (plen + torch.arange(S, device="cuda"))[None].int(), \
            kpos.int()

    cases = []
    lens = (120, 17, 130, 60, 2)
    seg = torch.repeat_interleave(torch.arange(5), torch.tensor(lens))
    cases.append(((1, 329, 8, 2, 128), 329,
                  dict(segment_ids=seg[None].int().cuda())))
    for win in (None, 96):
        qpos, kpos = prefix(300, 141, 250)
        cases.append(((1, 141, 8, 2, 128), 441,
                      dict(window=win, q_positions=qpos, kv_positions=kpos)))
    for hd in (112, 160):
        for H, K in ((4, 4), (8, 2)):
            cases.append(((1, 200, H, K, hd), 200, {}))
        qpos, kpos = prefix(200, 141, 150)
        cases.append(((1, 141, 8, 2, hd), 341,
                      dict(q_positions=qpos, kv_positions=kpos)))
    before = flash_attention.launches
    for (B, Sq, H, K, hd), Sk, kw in cases:
        q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, K, hd), rnd(B, Sk, K, hd)
        _close(flash_attention(q, k, v, **kw),
               ref.flash_attention(q, k, v, **kw), dtype)
    assert flash_attention.launches == before + len(cases)


def test_moe_engine_that_drops_at_decode_on_the_card_matches_the_cpu(card):
    """phi3.5-MoE reduced at ``capacity_factor=0.5`` and ``max_batch=16``
    (chip-smoke phase 8d at a small size), float32, TF32 off: a decode
    call routes 16 rows to 2 of 4 experts with 8 slots each, so decode
    calls drop. The card's engine gives the CPU engine's greedy streams,
    completion times and counters on the same weights, and each decode
    call drops as many assignments on both. The drops are counted by a
    wrapper of ``moe._route`` inside ``model.decode_pieces``, which a
    replayed decode graph does not call: that card engine runs its decode
    pieces as plain calls (``_graphed`` cleared). A default card engine,
    its decode graphs replayed, serves the same streams, completion times,
    ``sync_counts`` and paged-decode launches as the counted one."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import model, moe
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine
    cfg = get_config("phi3_5_moe_42b").reduced().with_(
        dtype="float32", param_dtype="float32", capacity_factor=0.5)
    scfg = dict(kvc_tokens=16 * 128, block_size=16, tfs=256,
                max_model_len=128, max_batch_reqs=16)
    route, pieces = moe._route, model.decode_pieces

    def run(device, params=None, graphed=False):
        drops, in_decode = [], []

        def decoding(*a, **kw):
            in_decode.append(True)
            try:
                return (yield from pieces(*a, **kw))
            finally:
                in_decode.pop()

        def counted(xf, router, k, E, Cl):
            out = route(xf, router, k, E, Cl)
            if in_decode:
                drops.append((~out[3]).sum())
            return out

        eng = ServingEngine(cfg, params, max_batch=16, capacity=128,
                            rl_accuracy=1.0, device=device,
                            scheduler_cfg=SchedulerConfig(**scfg))
        eng._graphed = graphed
        rng = np.random.default_rng(23)
        reqs = [GenRequest(prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(20, 61)))],
            params=SamplingParams(max_new_tokens=int(rng.integers(12, 25))))
            for _ in range(18)]
        if not graphed:     # a replay calls no Python: nothing to count
            moe._route, model.decode_pieces = counted, decoding
        try:
            eng.run(reqs)
        finally:
            moe._route, model.decode_pieces = route, pieces
        return eng, [(g.output, g.t_done) for g in reqs], \
            [int(d) for d in drops]

    paged_decode_attention.launches = 0
    gpu, got, got_drops = run("cuda")
    n_launches = paged_decode_attention.launches
    assert n_launches == cfg.num_layers * gpu.decode_iters
    cpu, want, want_drops = run("cpu", {k: t.cpu()
                                        for k, t in gpu.params.items()})
    assert got == want
    assert gpu.sync_counts == cpu.sync_counts
    assert got_drops == want_drops and sum(got_drops) > 0
    paged_decode_attention.launches = 0
    graphed, replayed, _ = run("cuda", gpu.params, graphed=True)
    assert replayed == got
    assert graphed.sync_counts == gpu.sync_counts
    assert paged_decode_attention.launches == n_launches
    assert graphed.n_graphed_decode_iters == graphed.decode_iters \
        == gpu.decode_iters
    assert graphed.n_decode_captures == 1 and gpu.n_decode_captures == 0


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3_8b", torch.float32), ("arctic_480b", torch.float32),
    ("mistral_nemo_12b", torch.float32), ("qwen3_8b", torch.bfloat16),
    ("mistral_nemo_12b", torch.bfloat16)],
    ids=["qwen3-f32", "arctic-f32", "ring-f32", "qwen3-bf16", "ring-bf16"])
def test_decode_step_with_inactive_rows_on_the_card(card, arch, dtype):
    """``model.decode_step`` over 16 rows with about half inactive, on
    caches filled from a seed (mistral-nemo's are rings of its 64-token
    window, written past their wrap; arctic routes 16 rows to 4 experts
    at capacity factor 0.5): on the card every row's logits equal those
    of the same call without a mask bit for bit, the inactive rows'
    caches are bitwise what they were, the active rows' equal the
    unmasked call's; and the logits agree with the CPU's from the same
    weights (float32 to 2e-5 of max|logit| with TF32 off, bf16 to 2**-4
    of it: each side rounds every layer's products to bf16). bf16 runs
    the dense and ring stacks only: a bf16 rounding may change an expert
    choice between the card and the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = get_config(arch).reduced().with_(dtype=name, param_dtype=name)
    if cfg.is_moe:
        cfg = cfg.with_(capacity_factor=0.5)
    B, cap = 16, 64 if cfg.sliding_window else 40
    gen = torch.Generator().manual_seed(5)
    cpu = model.init(cfg, gen, "cpu")
    caches = model.init_cache(cfg, B, cap, device="cpu")
    for n in ("k", "v"):
        caches["A"][n] = torch.randn(caches["A"][n].shape,
                                     generator=gen).to(dtype)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    pos = torch.randint(8, 2 * cap, (B,), generator=gen).int()
    if cfg.sliding_window is None:
        pos = pos.clamp(max=cap - 1)
    active = torch.rand(B, generator=gen) < 0.5
    active[:2] = torch.tensor([True, False])

    def step(params, device, mask):
        c = {"A": {n: t.clone().to(device) for n, t in caches["A"].items()}}
        lg, c = model.decode_step(cfg, params, toks.to(device),
                                  pos.to(device), c,
                                  active=None if mask is None
                                  else mask.to(device))
        return lg.float().cpu(), {n: t.cpu() for n, t in c["A"].items()}

    gpu = {k: p.cuda() for k, p in cpu.items()}
    paged_decode_attention.launches = 0
    got, got_c = step(gpu, "cuda", active)
    assert paged_decode_attention.launches == cfg.num_layers
    full, full_c = step(gpu, "cuda", None)
    assert torch.equal(got, full)
    for n in ("k", "v"):
        assert torch.equal(got_c[n][:, ~active], caches["A"][n][:, ~active])
        assert torch.equal(got_c[n][:, active], full_c[n][:, active])
    want, _ = step(cpu, "cpu", active)
    share = 2e-5 if dtype == torch.float32 else 2.0 ** -4
    assert float((got - want).abs().max()) <= share * float(want.abs().max())


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


def test_wrappers_refuse_inputs_that_require_grad_on_the_card(card):
    """A ctypes launch returns a tensor with no ``grad_fn``: each wrapper
    raises for an input that requires grad instead of losing the
    gradient."""
    from repro_torch.kernels.paged_attention import decode_rows
    q = torch.randn(1, 64, 4, 64, device="cuda", requires_grad=True)
    rows = torch.randn(1, 64, 4, 64, device="cuda")
    lens = torch.tensor([64], dtype=torch.int32, device="cuda")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="flash_attention"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="paged_decode_attention"):
        paged_decode_attention(q[:, 0], rows, rows, bt, lens)
    with pytest.raises(RuntimeError, match="decode_rows"):
        decode_rows(q[:, 0], rows, rows, lens, 64)
    with torch.no_grad():
        assert flash_attention(q, q, q).grad_fn is None


def test_train_step_on_the_card_matches_the_cpu(card):
    """Chip-smoke phase 11b at a small size: one train step of reduced
    qwen3 in float32 (TF32 off) at S = 2304, crossing both attention
    forms, on the card and on the CPU from the same weights and batch: the
    loss to 1e-5 relative and every grad to 1e-4 * max|g| per leaf
    (``make_grad_fn``); then ``apply_updates`` on each device from the
    CPU's grads, every updated param to 1e-5 (AdamW's first step turns a
    grad difference d near g = 0 into up to lr / eps * d of param, so the
    update is held on equal grads)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                                init_state)
    from repro_torch.training.train_loop import batch_to, make_grad_fn
    cfg = get_config("qwen3_8b").reduced(layers=2).with_(
        dtype="float32", param_dtype="float32", remat=True)
    opt = AdamWConfig(lr=3e-4, warmup_steps=5)
    cpu = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = {k: p.cuda() for k, p in cpu.items()}
    batch = next(SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=2304, batch_size=1)).batches())
    want_loss, _, want = make_grad_fn(cfg)(cpu, batch_to(batch, cfg, "cpu"))
    got_loss, _, got = make_grad_fn(cfg)(gpu, batch_to(batch, cfg, "cuda"))
    assert abs(float(got_loss) - float(want_loss)) \
        <= 1e-5 * abs(float(want_loss))
    for k, g in want.items():
        tol = 1e-4 * float(g.abs().max())
        assert float((got[k].cpu() - g).abs().max()) <= tol, k
    apply_updates(gpu, {k: g.cuda() for k, g in want.items()},
                  init_state(gpu, opt), opt)
    apply_updates(cpu, want, init_state(cpu, opt), opt)
    for k, p in cpu.items():
        assert float((gpu[k].detach().cpu() - p.detach()).abs().max()) \
            <= 1e-5, k


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "zamba2_7b",
                                  "xlstm_125m"])
def test_other_families_grad_step_on_the_card_matches_the_cpu(card, arch):
    """Chip-smoke phase 15d at a small size: one float32 grad step (TF32
    off, remat) of reduced phi3.5-MoE at ``capacity_factor=0.5`` (the
    backward through dropped assignments), zamba2 (the SSD chunk scan and
    the shared block) and xlstm (the sLSTM's per-token loop) on the card
    and on the CPU from the same weights and batch: the loss to 1e-5
    relative and every grad to 1e-4 * max|g| per leaf. The AdamW update is
    the same code for every family, and the qwen3 test above holds it."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.train_loop import batch_to, make_grad_fn
    cfg = get_config(arch).reduced(layers=4).with_(
        dtype="float32", param_dtype="float32", remat=True)
    if cfg.is_moe:
        cfg = cfg.with_(capacity_factor=0.5)
    cpu = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = {k: p.cuda() for k, p in cpu.items()}
    batch = next(SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, batch_size=2)).batches())
    want_loss, _, want = make_grad_fn(cfg)(cpu, batch_to(batch, cfg, "cpu"))
    got_loss, _, got = make_grad_fn(cfg)(gpu, batch_to(batch, cfg, "cuda"))
    assert abs(float(got_loss) - float(want_loss)) \
        <= 1e-5 * abs(float(want_loss))
    for k, g in want.items():
        tol = 1e-4 * float(g.abs().max())
        assert float((got[k].cpu() - g).abs().max()) <= tol, k


# --------------------------------------------------------------------- #
# the decode graphs (``serving/decode_graphs.py``) against eager decode
# --------------------------------------------------------------------- #
def _graph_engine(cfg, graphs: bool, params=None, K: int = 8, **kw):
    """A card engine whose decode graphs are replayed (``graphs``) or whose
    decode pieces run as plain calls (``_graphed`` cleared)."""
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(cfg, params, max_batch=8, capacity=256,
                        rl_accuracy=1.0, seed=0, device="cuda",
                        engine_cfg=EngineConfig(decode_megastep=K), **kw)
    assert eng._graphed
    eng._graphed = graphs
    return eng


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "phi3_5_moe_42b",
                                  "zamba2_7b"])
def test_decode_graphs_serve_what_eager_decode_serves(card, arch):
    """bf16 engines of reduced mistral-nemo (a 64-token window: ring
    caches), phi3.5-MoE and zamba2 (Mamba2 around its shared attention),
    each once with the decode graphs and once eagerly on the same weights:
    the same greedy streams, completion times, ``sync_counts`` and decode
    iterations, and as many paged-decode launches, one an attention call
    an iteration; every decode iteration replayed, after one capture."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config(arch).reduced()
    if arch == "mistral_nemo_12b":
        cfg = cfg.with_(sliding_window=64)
    n_attn = model.num_shared_invocations(cfg) + \
        sum(k == "A" for k in cfg.pattern())

    def run(graphs, params=None):
        eng = _graph_engine(cfg, graphs, params)
        paged_decode_attention.launches = 0
        reqs = _requests(cfg, 10, seed=5, lo=24, hi=120)
        eng.run(reqs)
        return eng, [(g.output, g.t_done) for g in reqs], \
            paged_decode_attention.launches

    graphed, got, got_n = run(True)
    eager, want, want_n = run(False, graphed.params)
    assert got == want
    assert graphed.sync_counts == eager.sync_counts
    assert graphed.decode_iters == eager.decode_iters > 0
    assert graphed.n_mega_windows == eager.n_mega_windows > 0
    assert got_n == want_n == n_attn * graphed.decode_iters
    assert graphed.n_graphed_decode_iters == graphed.decode_iters
    assert graphed.n_decode_captures == 1
    assert eager.n_graphed_decode_iters == eager.n_decode_captures == 0


def test_decode_graphs_keep_the_generator_rule(card):
    """Sampled rows (every third request at temperature 1.3, top-k 4)
    with an EOS token that cuts megastep windows while requests wait: the
    graphed engine at K = 8 serves the eager engine's K = 1 streams and
    completion times and leaves the generator in its state, as
    ``tests/test_torch_engine_rng.py`` asks of the eager windows."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving import GenRequest, SamplingParams
    cfg = get_config("qwen3_8b").reduced(layers=2).with_(vocab_size=256)
    scfg = SchedulerConfig(kvc_tokens=512, block_size=16, tfs=256,
                           max_model_len=256, max_batch_reqs=8,
                           reserve_frac=0.0, pad_ratio=0.0, bucket=16)

    def run(graphs, K, eos, params=None):
        eng = _graph_engine(cfg, graphs, params, K, scheduler_cfg=scfg)
        cuts, mega = [], eng._mega_fn

        def spy(active, k_iters, need_sample, need_topk, stop_on_eos):
            out = mega(active, k_iters, need_sample, need_topk, stop_on_eos)
            cuts.append(need_sample and stop_on_eos and bool(
                out[1][:k_iters - 1, active].any()))
            return out

        eng._mega_fn = spy
        reqs = [GenRequest(prompt=list(range(3 + i, 19 + i)),
                           params=SamplingParams(
                               max_new_tokens=112,
                               temperature=1.3 if i % 3 == 0 else 0.0,
                               top_k=4 if i % 3 == 0 else 0, eos_token=eos))
                for i in range(12)]
        eng.run(reqs)
        return eng, [(g.output, g.t_done) for g in reqs], sum(cuts)

    first, out, _ = run(False, 1, None)
    greedy = out[1][0]
    eos = greedy[int(0.7 * len(greedy))]
    k1, want, _ = run(False, 1, eos, first.params)
    k8, got, cuts = run(True, 8, eos, first.params)
    assert cuts > 0
    assert got == want
    assert torch.equal(k8.gen.get_state(), k1.gen.get_state())
    assert k8.n_graphed_decode_iters == k8.decode_iters > 0


def test_graphed_decode_calls_stay_visible_to_the_benchmark(card):
    """The benchmark's trace reads each paged-decode call's arguments by
    wrapping ``ops._decode_rows`` (``econobench.trace.record_calls``) and
    reads its context lengths once the slice has closed: under a graphed
    engine every call is recorded, with a tensor of its iteration's own
    (the calls of one iteration share it) that still holds the call's
    values at the end. Under ``torch.profiler``,
    ``econobench.trace.read`` gives ``engine.decode`` as many launches a
    decode iteration as the eager engine's, within 5%, and no device
    event carries the replay op's name."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from econobench import trace
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.decode_graphs import REPLAY
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cfg = _small_bf16()
    calls = trace.Calls(on=True)
    undo = trace.record_calls(calls)
    seen, inner = [], kops._decode_rows

    def keep(q, ck, cv, lens, page, **kw):
        seen.append(lens.clone())
        return inner(q, ck, cv, lens, page, **kw)

    kops._decode_rows = keep
    try:
        eng = _graph_engine(cfg, True)
        eng.run(_requests(cfg, 8, seed=2))
    finally:
        kops._decode_rows = inner
        undo()
    assert len(calls.decode) == len(seen) == \
        cfg.num_layers * eng.decode_iters > 0
    assert len({id(c[2]) for c in calls.decode}) == eng.decode_iters
    for (_, _, lens), want in zip(calls.decode, seen):
        assert torch.equal(lens, want)

    per_iter = {}
    for graphs in (True, False):
        eng = _graph_engine(cfg, graphs, eng.params)
        eng.run(_requests(cfg, 4, seed=3))      # the capture, outside
        reqs = _requests(cfg, 8, seed=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.SLICE_SPAN):
                it0 = eng.decode_iters
                eng.run(reqs)
                torch.cuda.synchronize()
        p = trace.read(prof)
        assert not any(REPLAY in e.name() for e in
                       prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA)
        per_iter[graphs] = p.span_launches["engine.decode"] / \
            (eng.decode_iters - it0)
    assert abs(per_iter[True] / per_iter[False] - 1) < 0.05, per_iter
