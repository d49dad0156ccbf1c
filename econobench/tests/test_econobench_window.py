"""The request-level arithmetic on hand-made timestamps."""
import pytest

from econobench import window
from econobench.window import Rec

W0, W1 = 10.0, 20.0


def rec(due, out, first=None, last=None, seen=0, done=None, failed=False,
        deadline=None):
    return Rec(due=due, out=out, deadline=due + 5 if deadline is None
               else deadline, first=first, last=last, seen=seen, done=done,
               failed=failed)


def test_observe_counts_new_tokens_once():
    r = rec(1.0, 3)
    assert r.observe(0, 1.5) == 0 and r.first is None
    assert r.observe(2, 2.0) == 2 and r.first == 2.0
    assert r.observe(2, 2.5) == 0 and r.last == 2.0
    assert r.observe(3, 3.0) == 1 and r.done == 3.0 and r.last == 3.0


def test_ttft_censored_and_failed():
    recs = [rec(11.0, 5, first=11.5, seen=1),          # 500 ms
            rec(12.0, 5),                              # none by W1: 8 s
            rec(5.0, 5, first=19.0, seen=1),           # due before: out
            rec(21.0, 5, first=21.1, seen=1)]          # due after: out
    assert window.ttft_p95_ms(recs, W0, W1) == pytest.approx(
        1e3 * (0.5 + 0.95 * 7.5))
    recs.append(rec(13.0, 5, failed=True))
    # a failure counts as the largest value of the sample (the window here)
    vals = sorted([0.5, 8.0, 10.0])
    import numpy as np
    assert window.ttft_p95_ms(recs, W0, W1) == pytest.approx(
        1e3 * np.percentile(vals, 95))


def test_tpot_counts_unfinished_requests():
    recs = [rec(11.0, 10, first=11.0, last=12.0, seen=5),   # 250 ms
            rec(12.0, 10, first=12.0, last=13.0, seen=11),  # 100 ms
            rec(13.0, 10, first=13.0, last=13.0, seen=1),   # one token: out
            rec(14.0, 10, first=14.0, last=16.0, seen=3, failed=True)]
    import numpy as np
    assert window.tpot_p95_ms(recs, W0, W1) == pytest.approx(
        1e3 * np.percentile([0.25, 0.1], 95))


def test_slo_deadlines_inside_the_window():
    recs = [rec(1.0, 3, done=11.0, deadline=12.0),      # met
            rec(2.0, 3, done=15.0, deadline=14.0),      # late
            rec(3.0, 3, deadline=16.0),                 # never completed
            rec(4.0, 3, done=5.0, deadline=9.0),        # deadline before
            rec(5.0, 3, done=30.0, deadline=25.0),      # deadline after
            rec(6.0, 3, done=11.0, deadline=18.0, failed=True)]
    assert window.slo_attain(recs, W0, W1) == pytest.approx(100.0 / 4)


def test_empty_samples_give_nothing():
    assert window.ttft_p95_ms([], W0, W1) is None
    assert window.tpot_p95_ms([], W0, W1) is None
    assert window.slo_attain([], W0, W1) is None
