"""The bf16 flash kernel's launch plan and the kernels' build key, on the
CPU (no card or nvcc needed):

* ``flash_prefill.plan`` for every head dim the wrapper takes and every
  (heads, kv heads, head dim) of the registry's attention configs, over
  short and long calls in every mask mode: shared memory within the
  H100's 232,448 bytes a block, 64 q rows a consumer warpgroup (wgmma's
  M), key tiles and head dims that are wgmma N widths (multiples of 8 up
  to 256) and contractions in steps of 16, a tile pair the kernel is
  instantiated for, and global strides that TMA takes (multiples of 16
  bytes);
* ``build._target``: the library's name changes with the source, with any
  ``csrc/`` header it includes, and with the flags."""
import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402

SMEM = 232448
# (block_q, block_k) pairs ``flash_bf16_kernel`` is instantiated for, by hd
PAIRS = {hd: {(64, 64), (128, 128)} if hd <= 128 else {(128, 64)}
         for hd in fp._HEAD_DIMS}


def _attention_shapes():
    out = set()
    for a in list_archs():
        cfg = get_config(a)
        if cfg.has_attention:
            out.add((cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim))
    return sorted(out)


SHAPES = _attention_shapes()


def test_registry_shapes_cover_every_config_head_dim():
    assert {hd for _, _, hd in SHAPES} == {64, 96, 112, 128, 160}


@pytest.mark.parametrize("hd", fp._HEAD_DIMS)
@pytest.mark.parametrize("positions,segments", [(False, False), (False, True),
                                                (True, False), (True, True)])
def test_plan_fits_shared_memory_and_wgmma_shapes(hd, positions, segments):
    for B, Sq, Sk, H in [(1, 1, 1, 1), (1, 64, 64, 4), (1, 130, 1154, 8),
                         (1, 512, 2560, 32), (1, 2048, 2048, 32),
                         (2, 1152, 1152, 32), (1, 10240, 10240, 32),
                         (1, 32768, 32768, 32), (8, 4096, 4096, 56),
                         (1, 4096, 131072, 32)]:
        p = fp.plan(B, Sq, Sk, H, hd, positions=positions,
                    segments=segments)
        assert p["smem"] <= SMEM, (B, Sq, Sk, H, hd, p)
        assert p["block_q"] == 64 * p["consumers"]      # M 64 a warpgroup
        assert p["threads"] == 128 * (p["consumers"] + 1)
        assert (p["block_q"], p["block_k"]) in PAIRS[hd], p
        for n in (p["block_k"], hd):                    # N of S and of P V
            assert n % 8 == 0 and 8 <= n <= 256
        for kdim in (hd, p["block_k"]):                 # contractions
            assert kdim % 16 == 0
        assert 2 <= p["stages"] <= fp.MAX_STAGES
        if p["consumers"] == 1:                         # two CTAs an SM
            assert 2 * (p["smem"] + 1024) <= 228 * 1024
        # one stage fewer is never chosen when one more fits
        if p["stages"] < (fp.MAX_STAGES if p["consumers"] == 2 else 2):
            nb = -(-hd // 64)
            stage = 2 * nb * p["block_k"] * 128 \
                + 4 * p["block_k"] * (positions + segments) + 32
            assert p["smem"] + stage > SMEM


def test_plan_spreads_short_calls_and_refuses_odd_head_dims():
    for B, S, H, hd in [(1, 512, 32, 128), (1, 2048, 32, 128),
                        (1, 1536, 32, 112), (2, 1152, 32, 96)]:
        assert fp.plan(B, S, S, H, hd)["block_q"] == 64
    for S in (10240, 32768):
        p = fp.plan(1, S, S, 32, 128)
        assert (p["block_q"], p["block_k"]) == (128, 128)
    for block_q in (None, 64, 128):
        p = fp.plan(1, 200, 200, 4, 160, block_q=block_q)
        assert (p["block_q"], p["block_k"]) == (128, 64)
    assert fp.plan(1, 200, 200, 4, 128, block_q=128)["block_q"] == 128
    assert fp.plan(1, 32768, 32768, 32, 128, block_q=64)["block_q"] == 64
    with pytest.raises(ValueError):
        fp.plan(1, 128, 128, 4, 128, block_q=96)
    for hd in (8, 40, 272):
        with pytest.raises(ValueError):
            fp.plan(1, 128, 128, 4, hd)


@pytest.mark.parametrize("H,K,hd", SHAPES)
def test_tma_strides_are_multiples_of_16_bytes(H, K, hd):
    """The tensor maps of q (B, Sq, H, hd) and k/v (B, Sk, K, hd) in bf16:
    every global stride (a head, a position, a batch row) a multiple of 16
    bytes, at any sequence length."""
    for heads in (H, K):
        for S in (1, 7, 130, 32768):
            for stride in (hd * 2, heads * hd * 2, S * heads * hd * 2):
                assert stride % 16 == 0, (H, K, hd, S)


def test_build_key_follows_headers_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// b\n")
    (csrc / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh",
                                                     "b.cuh"]
    base = build._target("k")
    (csrc / "other.cuh").write_text("// changed, not included\n")
    assert build._target("k") == base
    (csrc / "b.cuh").write_text("// b, edited\n")
    edited = build._target("k")
    assert edited != base
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lcuda"])
    assert build._target("k") != edited


def test_flash_library_key_covers_the_wgmma_header():
    names = [p.name for p in build.sources("flash_prefill")]
    assert names == ["flash_prefill.cu", "wgmma.cuh"]
