"""The per-layer readers and the slice's interval arithmetic on a
hand-made reading (a traced slice needs the card)."""
from collections import defaultdict
from types import SimpleNamespace

import pytest

from econobench import harness, trace
from econobench.window import Rec

SPANS = {"engine.prefill_wave": 0.02, "engine.prefill_chunks": 0.01,
         "engine.decode": 0.3}


def _s(**kw):
    prof = trace.Profile(
        window_s=2.0, busy_s=0.5,
        kernel_s={"flash": 0.01, "decode": 0.04, "other": 0.45},
        kernel_n={"flash": 80, "decode": 400, "other": 9000},
        span_s=dict(SPANS),
        span_launches={"engine.prefill_wave": 300,
                       "engine.prefill_chunks": 100,
                       "engine.decode": 25000},
        span_calls={"engine.prefill_wave": 1, "engine.prefill_chunks": 1,
                    "engine.decode": 12},
        moe_decode_s=0.0, top_ops=[], idle_gaps=[])
    c = harness.Counters(all_iters=10, all_rows=550, step_s=4.0,
                         tokens=1000, ctx=0)
    c.core = {1: SimpleNamespace(arrival=10.0, t_start_exec=10.2),
              2: SimpleNamespace(arrival=11.0, t_start_exec=None)}
    s = SimpleNamespace(
        prof=prof, counters=c, cfg=dict(
            layers=40, attn_layers=40, d=5120, heads=32, kv_heads=8,
            head_dim=128, d_ff=14336, vocab=131072, experts=0, top_k=2),
        calls=SimpleNamespace(flash=[(4e12, 1e9)], decode=[(1e9, 6.7e10)]),
        recs=[Rec(due=10.0, out=5, deadline=20.0, rid=1),
              Rec(due=11.0, out=5, deadline=20.0, rid=2)],
        w0=9.0, w1=12.0)
    s.__dict__.update(kw)
    return s


def _read(name, s):
    return harness.load_module(harness.HERE / "metrics"
                               / f"{name}.py").read(s)


def test_readers():
    s = _s()
    iters = 400 / 40                      # paged decode launches / layers
    assert _read("launches_per_decode_iter", s) == 25000 / iters
    assert _read("decode_ms_per_iter", s) == pytest.approx(1e3 * 0.3 / iters)
    assert _read("prefill_ms_per_call", s) == pytest.approx(
        1e3 * (0.02 + 0.01 + 0.01) / 2)
    assert _read("prefill_ms_per_call.out", s) == \
        _read("prefill_ms_per_call", s)
    assert _read("idle_share", s) == pytest.approx(75.0)
    assert _read("decode_rows_mean", s) == 55.0
    # 4 TFLOP at 989 TFLOP/s against 10 ms of flash; 67 GB at 3.35 TB/s
    # against 40 ms of decode
    assert _read("flash_roofline", s) == pytest.approx(
        100 * 4e12 / 989e12 / 0.01)
    assert _read("flash_roofline.out", s) == _read("flash_roofline", s)
    assert _read("decode_roofline", s) == pytest.approx(
        100 * 6.7e10 / 3.35e12 / 0.04)
    assert _read("mfu.open", s) == _read("mfu.out", s) == pytest.approx(
        100 * 1000 * 2 * 11_576_279_040 / (989e12 * 4.0))
    # waits of 200 ms and, never started, 1 s (the window's end)
    assert _read("queue_wait_p95_ms", s) == pytest.approx(
        200 + 0.95 * 800)


def test_readers_find_nothing_to_read():
    s = _s(calls=SimpleNamespace(flash=[], decode=[]))
    s.prof.kernel_n = {}
    s.counters.step_s = 0.0
    for name in ("flash_roofline", "decode_roofline", "decode_ms_per_iter",
                 "launches_per_decode_iter", "mfu.open"):
        assert _read(name, s) is None


def test_union_and_gaps():
    ns = 10 ** 9
    busy, gaps = trace._union([(1 * ns, 2 * ns), (1.5 * ns, 3 * ns),
                               (5 * ns, 6 * ns)], 0, 8 * ns)
    assert busy == pytest.approx(3.0)
    assert gaps == [(0, 1 * ns), (3 * ns, 5 * ns), (6 * ns, 8 * ns)]
    host = defaultdict(list, {"engine.decode": [(0, 2 * ns, "engine.decode")],
            "bench.step": [(0, 4.5 * ns, "bench.step")]})
    by = dict(trace._gaps_by_host(gaps, host))
    assert by == {"engine.decode": 1.0, "step outside the phases": 2.0,
                  "harness outside step": 2.0}


def test_live_rows_and_their_keys_and_values():
    cfg = SimpleNamespace(num_layers=40, num_kv_heads=8,
                          resolved_head_dim=128)
    c = harness.Counters(all_iters=10, all_rows=550, all_ctx=200_000,
                         max_rows=71)
    got = harness.live(SimpleNamespace(counters=c), cfg)
    # 160 KiB a token of context (k and v, 40 layers x 8 heads x 128, bf16)
    assert got == {"decode_rows_mean": 55.0, "decode_rows_max": 71,
                   "kv_live_bytes_mean": 163_840 * 20_000}
    assert harness.live(SimpleNamespace(counters=harness.Counters()),
                        cfg) == {}
