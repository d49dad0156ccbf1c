"""``scripts/serve_spans.py``: its six readings on synthetic windows, and
the benchmark's loop on a tiny cell on the CPU with the engine's spans and
stamps collected."""
import dataclasses
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from econobench import harness, traffic  # noqa: E402
from econobench.window import Rec  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "serve_spans", ROOT / "scripts" / "serve_spans.py")
ss = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ss)


def _ns(spans=None, iters=10, steps=20, gens=None, recs=()):
    spans = spans or {}
    return SimpleNamespace(
        spans={"ns": {n: v[0] for n, v in spans.items()},
               "calls": {n: v[1] for n, v in spans.items()}},
        iters=iters, steps=steps, gens=gens or {}, recs=list(recs),
        w0=100.0, w1=110.0)


@pytest.mark.parametrize("reading", ss.READINGS, ids=lambda f: f.__name__)
def test_readings_find_nothing_to_read(reading):
    """No calls of a reading's spans (and no stamps): None."""
    assert reading(_ns()) is None
    assert reading(_ns({"engine.decode": (0, 0), "engine.drain": (0, 0)},
                       iters=0, steps=0)) is None


def test_readings_of_a_synthetic_window():
    s = _ns({"engine.decode": (900_000_000, 12),
             "engine.drain": (30_000_000, 15),
             "scheduler.form_batch": (8_000_000, 20),
             "scheduler.finish_iteration": (2_000_000, 19),
             "kernels.decode_call": (12_000_000, 400),
             "engine.prefill_wave": (50_000_000, 3),
             "engine.prefill_chunks": (30_000_000, 1)})
    assert ss.decode_host_ms_per_iter(s) == pytest.approx(90.0)
    assert ss.drain_ms_per_iter(s) == pytest.approx(3.0)
    assert ss.sched_ms_per_step(s) == pytest.approx(0.5)
    assert ss.decode_call_us(s) == pytest.approx(30.0)
    assert ss.prefill_host_ms_per_call(s) == pytest.approx(20.0)


def test_first_token_drain_counts_an_undrained_request_at_its_age():
    """Requests due in the window: drained ones read their ring time, one
    not drained by w1 its age then, one sampled after w1 or due outside
    the window nothing."""
    def g(t0, t1):
        return SimpleNamespace(t_first_sampled=t0, t_first_drained=t1)
    gens = {0: g(101.0, 101.2), 1: g(102.0, None), 2: g(111.0, 111.5),
            3: g(99.0, 99.1), 4: g(109.0, 112.0)}
    recs = [Rec(due=100.5, out=4, deadline=200, rid=0),
            Rec(due=101.5, out=4, deadline=200, rid=1),
            Rec(due=109.9, out=4, deadline=200, rid=2),
            Rec(due=98.0, out=4, deadline=200, rid=3),
            Rec(due=108.0, out=4, deadline=200, rid=4)]
    s = _ns(gens=gens, recs=recs)
    # 0.2 s drained, 8 s (102 -> w1) undrained, 1 s (drained after w1)
    assert ss.first_token_drain_p95_ms(s) == pytest.approx(
        1e3 * float(np.percentile([0.2, 8.0, 1.0], 95)))


def test_window_takes_the_steps_between_the_marks():
    marks = [(t, {"ns": {"a": t}, "calls": {"a": 1}}, 2 * t, 0.5 * t)
             for t in (1, 2, 3, 5, 8, 9)]
    a, b, steps = ss.window(marks, 2.5, 6.0)
    assert (a[0], b[0], steps, b[2] - a[2], b[3] - a[3]) == (3, 8, 2, 10, 2.5)


def test_watched_loop_on_a_tiny_cell():
    """The benchmark's loop over a tiny ``chat`` cell on the CPU, spans
    and stamps collected: the readings are found, the drain is part of the
    decode's host time, which is part of ``step``'s, and each first
    token's stages add up to its time to first token."""
    cell = harness.load_cell("nemo12b.chat")
    cell = dataclasses.replace(
        cell, conf=dict(cell.conf, num_hidden_layers=2, hidden_size=64,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=16, intermediate_size=128, vocab_size=512),
        mix=dict(cell.mix, prompt=dict(cell.mix["prompt"], min=4, max=60),
                 output=dict(cell.mix["output"], min=6, max=20)),
        spec=dict(cell.spec, rows=4, capacity=96, preroll_s=0.5, rate=6.0))
    from repro_torch.obs import SpanTotals
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mcfg, _, eng = harness.build(cell, 5, "cpu")
        totals = eng.spans = SpanTotals()
        w = ss.Watch(eng, totals)
        items = traffic.stream(cell.mix, harness.n_items(cell, 1.5), 5,
                               capacity=96, vocab=mcfg.vocab_size,
                               rate=cell.spec["rate"])
        served = harness.drive(eng, items, cell.spec, 1.5, trace=False,
                               device="cpu")
    finally:
        torch.set_num_threads(n)
    out = ss.split(served, w)
    r = out["readings"]
    assert r["decode_host_ms_per_iter"] > 0 and r["sched_ms_per_step"] > 0
    assert r["decode_call_us"] > 0 and r["prefill_host_ms_per_call"] > 0
    assert r["first_token_drain_p95_ms"] >= 0
    assert r["drain_ms_per_iter"] <= r["decode_host_ms_per_iter"]
    host = out["host"]
    assert host["decode_iters"] > 0 and host["steps"] > 0
    assert r["decode_host_ms_per_iter"] * host["decode_iters"] \
        <= 1e3 * host["step_s"]
    assert out["spans"]["calls"]["scheduler.form_batch"] == host["steps"]
    tt = out["ttft_split"]
    assert tt["requests"] > 0
    assert all(tt[k]["p50"] >= 0 for k in ss.STAGES)
    assert sum(tt[k]["tail_mean"] for k in ss.STAGES) >= tt["ttft"]["p95"]
    assert out["end_to_end"]["ttft_p95_ms"] > 0
    # a CPU engine decodes eagerly: no graph is captured or replayed
    assert out["graphs"]["graphed_decode_iters"] == 0
    assert out["graphs"]["decode_captures"] == 0
    assert out["graphs"]["decode_capture_s"] == 0
