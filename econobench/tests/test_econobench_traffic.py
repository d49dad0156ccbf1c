"""The one traffic generator: the same seed gives the same stream, every
seed the same multiset of sizes and gaps, and every request fits the
cell's capacity."""
import numpy as np
import pytest

from econobench import traffic

SEEDS = (1, 2**31 + 11, 9_000_000_001)


@pytest.mark.parametrize("mix", ["chat", "docs"])
def test_repeats_by_seed(mix):
    m = traffic.load_mix(mix)
    a = traffic.stream(m, 200, SEEDS[1], capacity=2048, vocab=1000, rate=5.0)
    b = traffic.stream(m, 200, SEEDS[1], capacity=2048, vocab=1000, rate=5.0)
    assert [x.due for x in a] == [x.due for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = traffic.stream(m, 200, SEEDS[0], capacity=2048, vocab=1000, rate=5.0)
    assert [x.out for x in a] != [x.out for x in c]


@pytest.mark.parametrize("mix,capacity", [("chat", 2048), ("docs", 4096),
                                          ("docs", 2048)])
def test_same_work_every_seed_and_capacity_clip(mix, capacity):
    m = traffic.load_mix(mix)
    streams = [traffic.stream(m, 300, s, capacity=capacity, vocab=100,
                              rate=4.0) for s in SEEDS]
    outs = [sorted(x.out for x in st) for st in streams]
    gaps = [sorted(np.diff([0.0] + [x.due for x in st])) for st in streams]
    assert outs[0] == outs[1] == outs[2]
    for g in gaps[1:]:
        np.testing.assert_allclose(g, gaps[0])
    for st in streams:
        for x in st:
            assert len(x.prompt) >= 1
            assert len(x.prompt) + x.out <= capacity
            assert m["output"]["min"] <= x.out <= m["output"]["max"]
            assert x.prompt.min() >= 0 and x.prompt.max() < 100
            slo = m["slo"]
            assert x.slo == pytest.approx(
                slo["scale"] * (slo["t_p"] + slo["t_g"] * x.out))


def test_closed_loop_stream_is_due_at_zero():
    m = traffic.load_mix("chat")
    st = traffic.stream(m, 50, 3, capacity=2048, vocab=10)
    assert all(x.due == 0.0 for x in st)


def test_lengths_follow_the_mix():
    """ShareGPT's Table 2 means within the clip's pull, and the docs mix's
    medians."""
    p, o = traffic.sizes(traffic.load_mix("chat"), 20000)
    assert 140 < p.mean() < 175 and 300 < o.mean() < 345
    assert np.corrcoef(np.log(p), np.log(o))[0, 1] > 0.3
    p, o = traffic.sizes(traffic.load_mix("docs"), 20000)
    assert 1350 < np.median(p) < 1650 and 12 <= np.median(o) <= 14
