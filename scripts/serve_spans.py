"""Serve one cell of ``econobench`` with the engine's host spans and
first-token stamps collected, and print what they split as one JSON line.

    python3 scripts/serve_spans.py --workload nemo12b.chat --seed 7
    python3 scripts/serve_spans.py --workload nemo12b.chat --seed 7 --spans 0
    python3 scripts/serve_spans.py --root build/parent --workload ... --spans 0

The run is the benchmark's untraced run (``harness.build``,
``traffic.stream`` and ``harness.drive`` over the pre-roll and the
window): no profiler slows its host, so every reading covers the whole
window, the window ``ttft_p95_ms`` and ``out_tok_s`` are read over. With
``--spans 1`` a ``SpanTotals`` is attached to the engine. Printed:

* ``end_to_end``: the window's ``ttft_p95_ms`` and ``out_tok_s``, as the
  benchmark reads them;
* ``host``: the window's ``step`` calls, decode iterations
  (``decode_iters``) and host ms inside ``step`` a decode iteration (any
  checkout);
* ``spans``: the span totals of the window, ns and calls by name;
* ``readings``: the six readings below;
* ``decode_split``: host ms a decode iteration by span;
* ``graphs``: the decode graphs (``serving/decode_graphs.py``): decode
  iterations replayed in the window and their share of the window's
  ``decode_iters``, the captures of the whole run and their host seconds
  (``engine.decode_capture``; the captures fall in the pre-roll);
* ``ttft_split``: the time from a request's due time to its first token
  seen by the harness, over requests due in the window and seen in it, in
  stages: ``late`` (due to ``t_submit``: the harness's loop was inside
  ``step``), ``queue`` (to the scheduler's ``t_start_exec``), ``prefill``
  (to ``t_first_sampled``), ``ring`` (to ``t_first_drained``) and ``seen``
  (to the harness's read after ``step``); p50, p95, and the mean of each
  over the requests at or above the p95 of the whole.

``--root`` serves another checkout's port through that checkout's
``econobench`` (a port without spans: ``--spans 0``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------- #
# the readings, from a namespace: spans ({"ns", "calls"} of the window),
# iters and steps in it, gens (rid -> GenRequest), recs, w0, w1
# --------------------------------------------------------------------- #
def _ns(s, *names) -> int:
    return sum(s.spans["ns"].get(n, 0) for n in names)


def _calls(s, *names) -> int:
    return sum(s.spans["calls"].get(n, 0) for n in names)


def decode_host_ms_per_iter(s):
    """Host ms in ``engine.decode`` a decode iteration."""
    if not s.iters or not _calls(s, "engine.decode"):
        return None
    return 1e-6 * _ns(s, "engine.decode") / s.iters


def drain_ms_per_iter(s):
    """Host ms in ``engine.drain`` (in the decode and in the flushes) a
    decode iteration."""
    if not s.iters or not _calls(s, "engine.drain"):
        return None
    return 1e-6 * _ns(s, "engine.drain") / s.iters


def sched_ms_per_step(s):
    """Host ms in ``scheduler.form_batch`` and
    ``scheduler.finish_iteration`` a ``step`` call."""
    names = ("scheduler.form_batch", "scheduler.finish_iteration")
    if not s.steps or not _calls(s, *names):
        return None
    return 1e-6 * _ns(s, *names) / s.steps


def decode_call_us(s):
    """Host us a call of the paged decode wrapper (``kernels.decode_call``:
    from its entry to the return of its launch)."""
    n = _calls(s, "kernels.decode_call")
    return 1e-3 * _ns(s, "kernels.decode_call") / n if n else None


def prefill_host_ms_per_call(s):
    """Host ms a prefill range (``engine.prefill_wave`` or
    ``engine.prefill_chunks``) entered."""
    names = ("engine.prefill_wave", "engine.prefill_chunks")
    n = _calls(s, *names)
    return 1e-6 * _ns(s, *names) / n if n else None


def first_token_drain_p95_ms(s):
    """p95 of ``t_first_drained - t_first_sampled`` over the requests due
    in the window whose first token was sampled before its end; one not
    drained by ``w1`` counts at its age then."""
    vals = []
    for r in s.recs:
        g = s.gens.get(r.rid)
        if g is None or not s.w0 <= r.due < s.w1:
            continue
        t0 = getattr(g, "t_first_sampled", None)
        if t0 is None or t0 >= s.w1:
            continue
        t1 = g.t_first_drained
        vals.append((s.w1 if t1 is None else min(t1, s.w1)) - t0)
    return 1e3 * float(np.percentile(vals, 95)) if vals else None


READINGS = (decode_host_ms_per_iter, drain_ms_per_iter,
            first_token_drain_p95_ms, sched_ms_per_step, decode_call_us,
            prefill_host_ms_per_call)
DECODE_PARTS = ("engine.decode", "engine.decode_launch", "engine.drain",
                "engine.eos_readback", "engine.mega_replay",
                "kernels.decode_call", "engine.decode_capture",
                "engine.admit",
                "scheduler.form_batch", "scheduler.finish_iteration",
                "engine.prefill_wave", "engine.prefill_chunks")
STAGES = ("late", "queue", "prefill", "ring", "seen")


def ttft_split(recs, gens, core, w0, w1):
    """The stages of each first token (see the module), in ms."""
    rows = []
    for r in recs:
        g, c = gens.get(r.rid), core.get(r.rid)
        if (not w0 <= r.due < w1 or r.first is None or r.first > w1
                or g is None or c is None or c.t_start_exec is None
                or getattr(g, "t_first_drained", None) is None):
            continue
        t = (r.due, g.t_submit, c.t_start_exec, g.t_first_sampled,
             g.t_first_drained, r.first)
        rows.append([1e3 * (b - a) for a, b in zip(t, t[1:])])
    if not rows:
        return None
    a = np.asarray(rows)
    total = a.sum(axis=1)
    tail = a[total >= np.percentile(total, 95)]
    out = {"requests": len(rows),
           "ttft": {"p50": float(np.percentile(total, 50)),
                    "p95": float(np.percentile(total, 95))}}
    for i, name in enumerate(STAGES):
        out[name] = {"p50": float(np.percentile(a[:, i], 50)),
                     "p95": float(np.percentile(a[:, i], 95)),
                     "tail_mean": float(tail[:, i].mean())}
    return out


def window(marks, t0: float, t1: float):
    """The marks (now, snapshot, decode_iters, host seconds inside ``step``
    so far, graphed decode iterations) of the first steps at or
    after ``t0`` and ``t1``, and how many steps lie between them."""
    a = next(i for i, m in enumerate(marks) if m[0] >= t0)
    b = next(i for i, m in enumerate(marks) if m[0] >= t1)
    return marks[a], marks[b], b - a


class Watch:
    """Wraps the engine's ``step`` (a mark before each call, and its host
    seconds), ``submit`` (each ``GenRequest`` by rid) and the scheduler's
    ``on_arrival`` (each ``Request`` by rid)."""

    def __init__(self, eng, totals):
        self.eng, self.totals = eng, totals
        self.marks, self.gens, self.core = [], {}, {}
        self.step_s = 0.0
        step0, submit0 = eng.step, eng.submit
        arrive0 = eng.scheduler.on_arrival

        def step(now=None):
            self.mark(now)
            t = time.perf_counter()
            try:
                return step0(now)
            finally:
                self.step_s += time.perf_counter() - t

        def submit(req, now, dkey=None):
            rid = submit0(req, now, dkey)
            self.gens[rid] = req
            return rid

        def on_arrival(r, t):
            self.core[r.rid] = r
            return arrive0(r, t)

        eng.step, eng.submit = step, submit
        eng.scheduler.on_arrival = on_arrival

    def mark(self, now):
        self.marks.append((now, None if self.totals is None
                           else self.totals.snapshot(),
                           self.eng.decode_iters, self.step_s,
                           self.eng.n_graphed_decode_iters))


def split(served, w: Watch) -> dict:
    """Everything printed, from an untraced ``drive`` watched by ``w``."""
    from econobench import window as win
    w0, w1 = served.w0, served.w1
    w.mark(w1)
    a, b, steps = window(w.marks, w0, w1)
    iters = b[2] - a[2]
    step_s = b[3] - a[3]
    out = {"end_to_end": {
               "ttft_p95_ms": win.ttft_p95_ms(served.recs, w0, w1),
               "out_tok_s": served.tokens_in_window / (w1 - w0)},
           "host": {"steps": steps, "decode_iters": iters, "step_s": step_s,
                    "step_ms_per_decode_iter":
                        1e3 * step_s / iters if iters else None},
           "ttft_split": ttft_split(served.recs, w.gens, w.core, w0, w1),
           "graphs": {
               "graphed_decode_iters": b[4] - a[4],
               "graphed_share": (b[4] - a[4]) / iters if iters else None,
               "decode_captures": w.eng.n_decode_captures,
               "decode_capture_s": None if w.totals is None else
               1e-9 * w.totals.ns.get("engine.decode_capture", 0)}}
    if a[1] is None:
        return out
    from repro_torch.obs import SpanTotals
    spans = SpanTotals.between(a[1], b[1])
    s = SimpleNamespace(spans=spans, iters=iters, steps=steps, gens=w.gens,
                        recs=served.recs, w0=w0, w1=w1)
    out["spans"] = spans
    out["readings"] = {f.__name__: f(s) for f in READINGS}
    out["decode_split"] = {n: 1e-6 * spans["ns"].get(n, 0) / iters
                           for n in DECODE_PARTS} if iters else None
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose port and econobench serve")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    from econobench import env
    env.setup()
    import torch
    from econobench import harness, traffic
    if not torch.cuda.is_available():
        print("serve_spans: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = harness.load_cell(args.workload)
    mcfg, _, eng = harness.build(cell, args.seed, dev)
    totals = None
    if args.spans:
        from repro_torch.obs import SpanTotals
        totals = eng.spans = SpanTotals()
    w = Watch(eng, totals)
    items = traffic.stream(cell.mix, harness.n_items(cell, args.seconds),
                           args.seed, capacity=cell.spec["capacity"],
                           vocab=mcfg.vocab_size, rate=cell.spec.get("rate"))
    served = harness.drive(eng, items, cell.spec, args.seconds, trace=False,
                           device=dev)
    out = {"workload": args.workload, "seed": args.seed, "root": str(root),
           "spans_on": bool(args.spans),
           "device": torch.cuda.get_device_name(dev)}
    out.update(split(served, w))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
