"""Operations and bytes of the kernel calls and of a token, against
shapes worked by hand (and the phase-3 bounds of ``PERF.md``)."""
import pytest

from econobench import roofline as rl

INV = rl.POS_INVALID


@pytest.mark.parametrize("kw,want", [
    (dict(sq=4, sk=4), 10),                                   # causal
    (dict(sq=4, sk=4, window=2), 7),                          # + window
    (dict(sq=4, sk=4, seg_q=[0, 0, 1, 1]), 6),                # packed
    (dict(sq=4, sk=4, seg_q=[0, 0, 0, -1]), 7),               # a pad row
    (dict(sq=2, sk=5, pos_q=[2, 3], pos_k=[0, 1, INV, 2, 3]), 7),  # chunk
    (dict(sq=3, sk=7, pos_q=[1, 0, 1], seg_q=[0, 1, 1],       # chunk wave
          pos_k=[0, 1, 0, INV, 1, 0, 1], seg_k=[0, 0, 1, 1, 0, 1, 1]), 8),
])
def test_attended_pairs(kw, want):
    assert rl.attended_pairs(**kw) == want


def test_flash_call_packed_prefill_bound():
    """(1, 2048, 32, 128) over 8 kv heads: 41.9 MB moved, 0.0125 ms at
    3.35 TB/s, as phase 3's bound."""
    pairs = 8 * (256 * 257 // 2)
    f, b = rl.flash_call(1, 2048, 2048, 32, 8, 128, pairs)
    assert f == 4 * 32 * 128 * pairs
    assert b == 2 * 128 * (2 * 2048 * 32 + 2 * 2048 * 8)
    assert rl.bound_s(f, b) * 1e3 == pytest.approx(0.01252, abs=1e-5)


def test_decode_call_bound():
    """(8, 2048, 8, 128), H 32, contexts summing to 8234 keys: 0.0101 ms."""
    f, b = rl.decode_call(8234, 8, 32, 8, 128)
    assert b == 2 * 128 * (2 * 8 * 8234 + 2 * 8 * 32)
    assert f == 4 * 32 * 128 * 8234
    assert rl.bound_s(f, b) * 1e3 == pytest.approx(0.0101, abs=1e-4)


NEMO = dict(layers=40, d=5120, heads=32, kv_heads=8, head_dim=128,
            d_ff=14336, vocab=131072, experts=0, top_k=2)
PHI = dict(layers=22, d=4096, heads=32, kv_heads=8, head_dim=128,
           d_ff=6400, vocab=32064, experts=16, top_k=2)


def test_matmul_params():
    # 40 x (5120 x 128 x 80 + 3 x 5120 x 14336) + 5120 x 131072: the
    # 12.25B parameters less the embedding table
    assert rl.matmul_params(NEMO) == 40 * (52_428_800 + 220_200_960) \
        + 671_088_640
    # a MoE token passes the router and two of the 16 experts
    assert rl.matmul_params(PHI) == 22 * (4096 * 128 * 80
                                          + 2 * 3 * 4096 * 6400
                                          + 4096 * 16) + 4096 * 32064


def test_model_flops_and_step_share():
    assert rl.model_flops(NEMO, 3, 0) == 6 * rl.matmul_params(NEMO)
    assert rl.model_flops(NEMO, 1, 1000) == 2 * rl.matmul_params(NEMO) \
        + 4 * 40 * 32 * 128 * 1000
    # 1000 decode rows a second of 23.16 GFLOP each: 2.34% of 989 TFLOP/s
    share = rl.step_share(NEMO, 1000, 0, 1.0)
    assert share == pytest.approx(100 * 1000 * 2 * rl.matmul_params(NEMO)
                                  / 989e12)
    assert rl.step_share(NEMO, 0, 0, 1.0) is None
    assert rl.step_share(NEMO, 5, 0, 0.0) is None
