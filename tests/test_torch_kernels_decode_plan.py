"""The bf16 paged decode kernel's launch plan (``paged_attention.plan``),
on the CPU (no card or nvcc needed):

* shared memory within the H100's 232,448 bytes a block at every head dim
  the wrapper takes and every G = 1..16, two CTAs an SM, as many stages as
  that allows; wgmma's shapes (64-row tiles, N a multiple of 8 up to 256,
  contractions in steps of 16) for S^T = K Q^T and O^T = V^T P^T;
* splits that are whole tiles and cover the capacity exactly once;
* TMA boxes that never cross a page under a block table, and the cp.async
  copy for pages that are not a multiple of 8 slots;
* a grid of one whole wave of resident CTAs at the four serving shapes;
* the library's build key covering the shared ``tma.cuh`` and
  ``wgmma.cuh``, and the kernel's shared-memory formula the plan repeats."""
import math
import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

SMEM = 232448
SMEM_SM = 233472
HEAD_DIMS = pa._HEAD_DIMS
# (batch, heads, kv heads, hd, capacity): full 8192-slot rings
# (mistral-nemo), qwen3's decode_32k, the engine's (8, 2048) rows, zamba2
SERVING = [(4, 32, 8, 128, 8192), (8, 32, 8, 128, 32768),
           (8, 32, 8, 128, 2048), (8, 32, 32, 112, 2048)]


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("G", range(1, pa.MAX_GROUP + 1))
def test_plan_fits_shared_memory_and_wgmma_shapes(hd, G):
    for B, K, cap, page in [(1, 1, 64, 64), (4, 2, 1024, 16),
                            (8, 8, 2048, 2048), (4, 8, 8192, 8192),
                            (8, 8, 32768, 128)]:
        p = pa.plan(B, G * K, K, hd, cap, page)
        assert p["smem"] <= SMEM, (hd, G, p)
        assert 2 * (p["smem"] + 1024) <= SMEM_SM            # two CTAs an SM
        assert p["ctas_per_sm"] == SMEM_SM // (p["smem"] + 1024) >= 2
        assert 2 <= p["stages"] <= pa.MAX_STAGES
        if p["stages"] < pa.MAX_STAGES:                     # no stage left
            assert 2 * (pa.smem_bytes(hd, G, p["stages"] + 1) + 1024) \
                > SMEM_SM
        assert p["threads"] == 160                          # 4 warps + 1
        gb = p["group"]
        assert G <= gb and gb in (4, 8, 16)
        for n in (max(8, gb), 2 * gb):                      # N of S^T, O^T
            assert n % 8 == 0 and 8 <= n <= 256
        assert hd % 16 == 0 and p["tile"] % 16 == 0         # contractions
        assert p["tile"] == 64                              # M of both


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_split_is_whole_tiles_and_covers_the_capacity(hd):
    for B, H, K in [(1, 1, 1), (3, 8, 2), (8, 32, 8), (8, 32, 32),
                    (64, 64, 8), (2, 16, 1)]:
        for cap in (1, 63, 64, 96, 100, 1000, 2048, 8192, 32768, 131072):
            p = pa.plan(B, H, K, hd, cap, cap)
            split, n = p["split"], p["n_split"]
            assert split % p["tile"] == 0 and split >= p["tile"]
            assert split * n >= cap > split * (n - 1)
            assert p["grid"] == B * K * n


@pytest.mark.parametrize("page", [8, 16, 24, 32, 48, 64, 96, 128, 256, 640])
def test_no_box_crosses_a_page(page):
    """Under a block table the producer copies a tile as boxes of ``box``
    rows, starting at the tile's first key; each box lies inside one page.
    Under contiguous rows (one page a row) a box is the whole tile."""
    for MP in (1, 2, 7, 64):
        cap = MP * page
        p = pa.plan(4, 16, 4, 128, cap, page)
        box, tile = p["box"], p["tile"]
        assert tile % box == 0 and box % 8 == 0
        if MP == 1:
            assert box == tile
            continue
        assert page % box == 0
        for t0 in range(0, cap, p["split"]):
            for base in range(t0, min(t0 + p["split"], cap), tile):
                for j in range(tile // box):
                    t = base + j * box
                    assert t // page == (t + box - 1) // page, (page, t)


@pytest.mark.parametrize("page", [1, 4, 12, 20])
def test_pages_not_a_multiple_of_8_give_boxes_under_8_rows(page):
    """Pages that are not a multiple of 8 slots would give TMA boxes under
    8 rows, which a 128-byte-swizzled box (whole 8-row atoms) does not
    take: the plan copies them by cp.async instead, with no box, and keeps
    everything else of the kernel's plan (split, stages, shared memory)."""
    for MP in (2, 7, 64):
        cap = MP * page
        p = pa.plan(2, 8, 2, 64, cap, page)
        assert math.gcd(page, p["tile"]) % 8
        assert p["copy"] == "cp.async" and p["box"] is None
        q = pa.plan(2, 8, 2, 64, cap, 8 * page)       # the same, but TMA
        assert q["copy"] == "tma"
        assert {k: v for k, v in p.items() if k not in ("copy", "box")} \
            == {k: v for k, v in q.items() if k not in ("copy", "box")}
    # one page a row: the tile is one TMA box, at any page size
    assert pa.plan(2, 8, 2, 64, page, page)["copy"] == "tma"


def test_pages_of_a_multiple_of_8_keep_their_tma_boxes():
    """Every page size that is a multiple of 8 slots keeps the TMA copy
    with the boxes it had before the cp.async copy existed: the tile under
    one page a row, else gcd(page, 64) rows."""
    for page in range(8, 1025, 8):
        for MP in (1, 2, 7):
            p = pa.plan(4, 16, 4, 128, MP * page, page)
            assert p["copy"] == "tma"
            assert p["box"] == (64 if MP == 1 else math.gcd(page, 64))


def test_cp_async_copy_arrives_once_a_lane():
    """The cp.async instance's full barriers expect one arrival from each
    of the producer warp's 32 lanes, which each make one a tile; the TMA
    instance's expect one, with the tile's bytes. No combine kernel is
    left: both dtypes merge their splits in the split kernel."""
    src = (build.CSRC / "paged_decode.cu").read_text()
    assert "mbar_init(full + 8 * s, CPA ? 32 : 1);" in src
    assert src.count("cp_async_arrive(full + 8 * s);") == 1
    assert src.count("mbar_expect_tx(full + 8 * s, 2 * C::KV_BYTES);") == 1
    assert "combine_kernel" not in src
    assert src.count("merge_if_last<T, HD>(") == 2          # float32
    assert src.count("merge_if_last<bf16, HD>(") == 2


@pytest.mark.parametrize("shape", SERVING, ids=["rings", "decode_32k",
                                                "rows_2048", "zamba2"])
def test_grid_is_one_whole_wave_at_the_serving_shapes(shape):
    B, H, K, hd, cap = shape
    p = pa.plan(B, H, K, hd, cap, cap)
    slots = p["ctas_per_sm"] * pa.N_SM
    assert p["ctas_per_sm"] == 2
    # the wave is full: one more split of every row would start a second
    assert slots - B * K < p["grid"] <= slots
    assert p["waves"] == p["grid"] / slots
    assert not p["box"] % 8


def test_serving_splits():
    assert [(pa.plan(B, H, K, hd, c, c)["n_split"],
             pa.plan(B, H, K, hd, c, c)["split"])
            for B, H, K, hd, c in SERVING] == [(8, 1024), (4, 8192), (4, 512),
                                              (1, 2048)]


def test_decode_library_key_covers_the_shared_headers():
    names = [p.name for p in build.sources("paged_decode")]
    assert names == ["paged_decode.cu", "tma.cuh", "wgmma.cuh"]


def test_plan_repeats_the_kernel_shared_memory():
    """``smem_bytes`` is ``DecCfg::bytes`` of ``csrc/paged_decode.cu``: the
    same tile, boxes, operands and barriers, term by term."""
    src = (build.CSRC / "paged_decode.cu").read_text()
    cfg = src[src.index("struct DecCfg"):src.index("};", src.index(
        "struct DecCfg"))]
    assert re.search(r"TK = 64;", cfg)
    assert re.search(r"NS = GB < 8 \? 8 : GB;", cfg)
    assert re.search(r"NO = 2 \* GB;", cfg)
    assert re.search(r"RED_BYTES = 2 \* NWARPS \* MAXG \* 4;", cfg)
    assert "1024 + (size_t)stages * 2 * KV_BYTES + Q_BYTES + P_BYTES + " \
           "RED_BYTES + 16 * stages" in cfg
    # hd 128, G 4, 3 stages: 1024 + 3 * 32768 + 2048 + 1024 + 512 + 48
    assert pa.smem_bytes(128, 4, 3) == 102960
    assert pa.smem_bytes(160, 16, 2) == 1024 + 2 * 49152 + 3 * 16 * 128 \
        + 32 * 128 + 512 + 32
