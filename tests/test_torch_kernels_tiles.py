"""Plain models of how the two CUDA attention kernels cut their work, held
against the plain versions in ``repro_torch.kernels.ref`` (and so, through
``test_torch_kernels*.py``, against the JAX oracles):

* the split-KV decode kernel: float32 partials (m, l, acc) of each key
  range that ``paged_attention.plan`` gives, merged by log-sum-exp;
* the flash kernel's tile skipping (``tile_plan``, the kernel's pre-pass
  rule in plain PyTorch, at the tile sizes the kernel runs: 64 q rows a
  consumer warpgroup, 64 or 128 keys, as ``flash_prefill.plan`` picks
  them): every tile it skips is fully masked, every tile it marks full has
  no masked pair, and attention over the kept tiles only, with the
  kernel's rule for rows that see no key, equals the plain version;
* the bf16 kernel's launch plan (``flash_prefill.plan``) against the
  card's shared memory and wgmma's shapes, for every config's head dim.

Inputs are made with numpy from a seed; everything runs in float32."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_prefill import TILE, plan  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    TILE as SPLIT_ALIGN, plan as decode_plan)
from repro_torch.kernels.ref import NEG_INF, POS_INVALID  # noqa: E402
from repro_torch.serving.engine import packed_chunk_layout  # noqa: E402


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# --------------------------------------------------------------------------- #
# split-KV decode
# --------------------------------------------------------------------------- #
def split_kv_decode(q, k_pages, v_pages, block_tables, context_lens, *,
                    softcap=None, n_sm=132):
    """What ``paged_decode.cu`` computes, step by step: per (row, kv head,
    split) the float32 partial max m, denominator l and unnormalised
    P @ V over the split's keys below the context (a split past the
    context is neutral: m = NEG_INF, l = 0), then the combine."""
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    G = H // K
    MP = block_tables.shape[1]
    p = decode_plan(B, H, K, hd, MP * page, page, n_sm)
    split, n_split = p["split"], p["n_split"]
    keys = k_pages[block_tables.long()].reshape(B, MP * page, K, hd).float()
    vals = v_pages[block_tables.long()].reshape(B, MP * page, K, hd).float()
    qf = q.float().reshape(B, K, G, hd)
    m = torch.full((B, K, n_split, G), NEG_INF)
    l = torch.zeros(B, K, n_split, G)
    acc = torch.zeros(B, K, n_split, G, hd)
    for b in range(B):
        ctx = min(int(context_lens[b]), MP * page)
        for s in range(n_split):
            t0, t1 = s * split, min((s + 1) * split, ctx)
            if t0 >= ctx:
                continue
            x = torch.einsum("kgh,tkh->kgt", qf[b], keys[b, t0:t1])
            x = x / math.sqrt(hd)
            if softcap:
                x = softcap * torch.tanh(x / softcap)
            mx = x.amax(-1)
            p = torch.exp(x - mx[..., None])
            m[b, :, s], l[b, :, s] = mx, p.sum(-1)
            acc[b, :, s] = torch.einsum("kgt,tkh->kgh", p, vals[b, t0:t1])
    # combine: log-sum-exp over the splits that saw a key
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(2,
                                                                keepdim=True)
    w = torch.where(live, torch.exp(m - M), torch.zeros_like(m))
    L = (l * w).sum(2)
    out = (acc * w[..., None]).sum(2) / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def test_plan_splits_takes_shapes_only():
    params = list(inspect.signature(decode_plan).parameters)
    assert params == ["batch", "heads", "kv_heads", "hd", "capacity", "page",
                      "n_sm"]
    p = decode_plan(8, 32, 8, 128, 2048, 2048)        # the serving shape
    assert (p["split"], p["n_split"]) == (512, 4)
    for B, K, cap in [(1, 1, 64), (1, 1, 2048), (3, 2, 1000), (8, 8, 2048),
                      (64, 8, 32768), (4, 4, 96), (2, 8, 100)]:
        p = decode_plan(B, 4 * K, K, 128, cap, cap)
        split, n = p["split"], p["n_split"]
        assert split % SPLIT_ALIGN == 0 and split >= SPLIT_ALIGN
        assert split * n >= cap > split * (n - 1)
        # at most one wave of the CTAs an SM holds (or the rows alone
        # where they fill it), and at least half of the splits that fit
        # it, as far as the capacity has tiles for them
        slots = p["ctas_per_sm"] * 132
        assert B * K * n <= max(slots, B * K)
        assert 2 * n >= min(slots // (B * K), cap // SPLIT_ALIGN)


@pytest.mark.parametrize("softcap", [None, 25.0])
@pytest.mark.parametrize("B,H,K,hd,page,MP", [
    (4, 8, 2, 64, 16, 64),      # 1024 slots: 16 splits of 64
    (8, 32, 8, 128, 128, 16),   # the serving shape: 4 splits of 512
    (3, 8, 1, 32, 8, 7),        # one split
])
def test_split_kv_model_matches_plain(B, H, K, hd, page, MP, softcap):
    rng = np.random.default_rng(7)
    P = B * MP + 2
    cap = MP * page
    p = decode_plan(B, H, K, hd, cap, page)
    split, n = p["split"], p["n_split"]
    q = _t(rng.standard_normal((B, H, hd)))
    kp = _t(rng.standard_normal((P, page, K, hd)))
    vp = _t(rng.standard_normal((P, page, K, hd)))
    bt = _t(rng.permutation(P)[:B * MP].reshape(B, MP), torch.int32)
    # ctx 0, 1, split edges +-1, full, and one row inside the first split
    # beside a full one
    edges = [0, 1, split - 1, split, split + 1, cap - 1, cap,
             min(3, cap), 2 * split + 1]
    for start in range(0, len(edges), B):
        ctx = [edges[(start + i) % len(edges)] for i in range(B)]
        ctx = [min(max(c, 0), cap) for c in ctx]
        cl = torch.tensor(ctx, dtype=torch.int32)
        got = split_kv_decode(q, kp, vp, bt, cl, softcap=softcap)
        want = ref.paged_decode_attention(q, kp, vp, bt, cl, softcap=softcap)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        for b, c in enumerate(ctx):
            if c == 0:
                assert torch.count_nonzero(got[b]) == 0


# --------------------------------------------------------------------------- #
# flash tile skipping
# --------------------------------------------------------------------------- #
# (q rows, keys) of the tiles the kernels skip by: the float32 kernel's and
# the bf16 kernel's one-consumer tiles, and the bf16 two-consumer tiles
# (each consumer skips by its 64 rows)
KERNEL_TILES = ((TILE, TILE), (TILE, 2 * TILE))


def _minmax(x: torch.Tensor, valid: torch.Tensor, n: int, tile: int = TILE):
    """Per tile of ``tile`` along dim 1: min and max of x over valid entries
    (min > max where a tile has none), shapes (B, n)."""
    B, S = x.shape
    pad = n * tile - S
    x = torch.nn.functional.pad(x, (0, pad)).reshape(B, n, tile)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(B, n, tile)
    big = torch.iinfo(torch.int32).max
    lo = torch.where(valid, x, big).amin(-1)
    hi = torch.where(valid, x, -big - 1).amax(-1)
    return lo, hi


def tile_plan(Sq, Sk, *, causal=True, window=None, segment_ids=None,
              kv_segment_ids=None, q_positions=None, kv_positions=None,
              q_tile=TILE, k_tile=TILE):
    """The pre-pass rule of ``kernels/csrc/flash_prefill.cu`` in plain
    PyTorch, for q tiles of ``q_tile`` rows and k tiles of ``k_tile`` keys
    (the kernel combines its 64-row, 64-key pre-pass ranges into these).
    Returns (keep, full), both (B, nq, nk) bool: keep where the kernel
    computes k tile j for q tile i, full where it also skips the masks. A tile is skipped when it has no valid key, lies
    wholly above the causal diagonal, wholly before the window of the q
    tile's least position, or has a segment range disjoint from the q
    tile's; it is full when every key is valid, below every q position,
    inside every window, and both sides hold one same segment."""
    B = 1
    for a in (segment_ids, kv_segment_ids, q_positions, kv_positions):
        if a is not None:
            B = max(B, a.shape[0])
    nq, nk = -(-Sq // q_tile), -(-Sk // k_tile)
    qp = torch.arange(Sq)[None].expand(B, Sq) if q_positions is None \
        else q_positions.long().expand(B, Sq)
    kp = torch.arange(Sk)[None].expand(B, Sk) if kv_positions is None \
        else kv_positions.long().expand(B, Sk)
    kvalid = kp < POS_INVALID
    qvalid = torch.ones(B, Sq, dtype=torch.bool)
    qs = torch.zeros(B, Sq, dtype=torch.int64) if segment_ids is None \
        else segment_ids.long().expand(B, Sq)
    ks_src = kv_segment_ids if kv_segment_ids is not None else segment_ids
    ks = torch.zeros(B, Sk, dtype=torch.int64) if ks_src is None \
        else ks_src.long().expand(B, Sk)
    qp_lo, qp_hi = _minmax(qp, qvalid, nq, q_tile)
    qs_lo, qs_hi = _minmax(qs, qvalid, nq, q_tile)
    kp_lo, kp_hi = _minmax(kp, kvalid, nk, k_tile)
    ks_lo, ks_hi = _minmax(ks, kvalid, nk, k_tile)
    kall = torch.nn.functional.pad(kvalid, (0, nk * k_tile - Sk)).reshape(
        B, nk, k_tile).all(-1)
    keep = (kp_lo <= kp_hi)[:, None, :].expand(B, nq, nk).clone()
    full = kall[:, None, :].expand(B, nq, nk).clone()
    if causal:
        keep &= ~(kp_lo[:, None, :] > qp_hi[:, :, None])
        full &= kp_hi[:, None, :] <= qp_lo[:, :, None]
    if window:
        keep &= ~(kp_hi[:, None, :] <= qp_lo[:, :, None] - window)
        full &= kp_lo[:, None, :] > qp_hi[:, :, None] - window
    if segment_ids is not None:
        keep &= ~((ks_hi[:, None, :] < qs_lo[:, :, None])
                  | (ks_lo[:, None, :] > qs_hi[:, :, None]))
        full &= ((ks_lo == ks_hi)[:, None, :] & (qs_lo == qs_hi)[:, :, None]
                 & (ks_lo[:, None, :] == qs_lo[:, :, None]))
    return keep, keep & full


def _mask(Sq, Sk, causal=True, window=None, segment_ids=None,
          kv_segment_ids=None, q_positions=None, kv_positions=None):
    """The (B, Sq, Sk) mask of ``ref.flash_attention``."""
    if q_positions is not None:
        ii, jj = q_positions[:, :, None], kv_positions[:, None, :]
        mask = jj < POS_INVALID
    else:
        ii = torch.arange(Sq)[None, :, None]
        jj = torch.arange(Sk)[None, None, :]
        mask = torch.ones((1, Sq, Sk), dtype=torch.bool)
    if causal:
        mask = mask & (jj <= ii)
    if window is not None:
        mask = mask & (jj > ii - window)
    if segment_ids is not None:
        sk = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = mask & (segment_ids[:, :, None] == sk[:, None, :])
    return mask


def skipped_flash(q, k, v, keep, mask, q_tile=TILE, k_tile=TILE):
    """Attention over the kept tiles only, as the kernel runs it; a row
    that sees no key gets the mean of V over all keys."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    cols = keep.repeat_interleave(q_tile, 1).repeat_interleave(k_tile, 2)
    cols = cols[:, :Sq, :Sk]
    x = torch.einsum("bskgh,btkh->bkgst", q.reshape(B, Sq, K, G, hd), k)
    x = x / math.sqrt(hd)
    m = (mask.expand(B, Sq, Sk) & cols)[:, None, None]
    x = x.masked_fill(~m, -math.inf)
    seen = m.any(-1, keepdim=True)
    w = torch.softmax(torch.where(seen, x, torch.zeros_like(x)), -1)
    w = torch.where(seen, w, torch.full_like(w, 1.0 / Sk))
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _layouts():
    """(label, Sq, Sk, mask kwargs) over the layouts of the flash tests
    and of ``packed_chunk_layout`` waves."""
    for S, win in [(256, None), (200, None), (384, 128), (130, 64),
                   (2048, None)]:
        yield f"implicit S{S} win{win}", S, S, dict(window=win)
    for lens, win in [((48, 80), None), ((17, 60, 51), None),
                      ((100, 28), 32), ((5, 3, 90, 30), None),
                      ((63, 2, 66, 129), None), ((256,) * 8, None)]:
        S = sum(lens)
        seg = torch.repeat_interleave(torch.arange(len(lens)),
                                      torch.tensor(lens))[None]
        yield f"segments {lens} win{win}", S, S, dict(window=win,
                                                      segment_ids=seg)
    for C, S, plen, win in [(64, 48, 40, None), (96, 17, 60, None),
                            (128, 33, 100, 48), (64, 48, 0, None),
                            (2048, 512, 1024, None), (1024, 40, 5, None),
                            (256, 100, 200, 64)]:
        slot = torch.arange(C)
        qpos = (plen + torch.arange(S))[None].expand(2, S)
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S)])[None].expand(2, C + S)
        yield (f"positions C{C} S{S} plen{plen} win{win}", S, C + S,
               dict(window=win, q_positions=qpos, kv_positions=kpos))
    for starts, lens, cap in [((40, 0), (24, 30), 64),
                              ((60, 32, 5), (17, 33, 8), 64),
                              ((1792, 640, 0), (256, 384, 512), 2048),
                              ((300, 0, 1000, 64), (200, 64, 48, 130), 2048)]:
        pos, seg, ppos, pseg, _ = packed_chunk_layout(starts, lens, cap)
        pos, seg = _t(pos, torch.int64), _t(seg, torch.int64)
        kpos = torch.cat([_t(ppos, torch.int64), pos], 1)
        kseg = torch.cat([_t(pseg, torch.int64), seg], 1)
        yield (f"chunk wave starts {starts} lens {lens}", pos.shape[1],
               kpos.shape[1], dict(segment_ids=seg, kv_segment_ids=kseg,
                                   q_positions=pos, kv_positions=kpos))


LAYOUTS = list(_layouts())


@pytest.mark.parametrize("label,Sq,Sk,kw", LAYOUTS,
                         ids=[lay[0] for lay in LAYOUTS])
def test_skipped_tiles_are_fully_masked(label, Sq, Sk, kw):
    for tq, tk in KERNEL_TILES:
        keep, full = tile_plan(Sq, Sk, q_tile=tq, k_tile=tk, **kw)
        mask = _mask(Sq, Sk, **kw)
        B = keep.shape[0]
        mask = mask.expand(B, Sq, Sk)
        nq, nk = keep.shape[1:]
        pad = torch.zeros(B, nq * tq, nk * tk, dtype=torch.bool)
        pad[:, :Sq, :Sk] = mask
        tiles = pad.reshape(B, nq, tq, nk, tk)
        any_pair = tiles.any(4).any(2)
        assert not (any_pair & ~keep).any(), (label, tq, tk)
        # a full tile: every (valid query row, key) pair unmasked
        rows = torch.zeros(nq * tq, dtype=torch.bool)
        rows[:Sq] = True
        rows = rows.reshape(nq, tq)[None, :, :, None, None]
        all_pair = (tiles | ~rows).all(4).all(2)
        assert not (full & ~all_pair).any(), (label, tq, tk)
        # the rule is not vacuous where the masks leave whole tiles empty
        if "chunk wave starts (1792" in label or "(256, 256" in label:
            assert keep.float().mean() < 0.5
        if "plen1024" in label:         # the prefix of a chunk needs no mask
            assert full.sum() >= (1024 // tk) * (512 // tq)


@pytest.mark.parametrize("label,Sq,Sk,kw", LAYOUTS,
                         ids=[lay[0] for lay in LAYOUTS])
def test_attention_over_kept_tiles_equals_plain(label, Sq, Sk, kw):
    rng = np.random.default_rng(3)
    B = kw["q_positions"].shape[0] if "q_positions" in kw else 1
    q = _t(rng.standard_normal((B, Sq, 2, 32)))
    k = _t(rng.standard_normal((B, Sk, 1, 32)))
    v = _t(rng.standard_normal((B, Sk, 1, 32)))
    want = ref.flash_attention(q, k, v, **kw)
    for tq, tk in KERNEL_TILES:
        keep, _ = tile_plan(Sq, Sk, q_tile=tq, k_tile=tk, **kw)
        got = skipped_flash(q, k, v, keep, _mask(Sq, Sk, **kw), tq, tk)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_row_with_no_valid_key_gets_the_mean_of_v():
    """Queries placed before every key: the plain version gives each the
    uniform mean of V over all Sk keys, and so does the skipping model,
    although every tile is skipped for them."""
    rng = np.random.default_rng(5)
    Sq, Sk = 70, 150
    qpos = torch.arange(Sq)[None]
    kpos = torch.where(torch.arange(Sk) < 20, POS_INVALID,
                       100 + torch.arange(Sk))[None]
    kw = dict(q_positions=qpos, kv_positions=kpos)
    q = _t(rng.standard_normal((1, Sq, 2, 32)))
    k = _t(rng.standard_normal((1, Sk, 1, 32)))
    v = _t(rng.standard_normal((1, Sk, 1, 32)))
    keep, _ = tile_plan(Sq, Sk, **kw)
    assert not keep.any()
    want = ref.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(want[0, :, 0], v[0, :, 0].mean(0).expand(
        Sq, 32), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(skipped_flash(q, k, v, keep, _mask(
        Sq, Sk, **kw)), want, atol=1e-6, rtol=1e-6)
