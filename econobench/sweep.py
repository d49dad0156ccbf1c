"""The knee of an open cell, on the card, in one process: the cell at each
of a list of fixed rates (weights made once; a fresh engine, pre-roll and
window at each rate). Prints, a rate a line, the offered and served output
tokens/s, the tails, the SLO attainment and the backlog (requests
submitted and not finished) at the window's start and end. Not run by the
benchmark's own runs; the cell's ``rate`` is written from its reading.

    python3 econobench/sweep.py --workload nemo12b.chat --seconds 20 --rates 6,8,10,12
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from econobench import env  # noqa: E402

env.setup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    from econobench import harness, window
    from econobench.weights import make_params
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mcfg = harness.port_config(cell.conf)
    params = make_params(mcfg, args.seed, dev)
    for rate in (float(r) for r in args.rates.split(",")):
        c = dataclasses.replace(cell, spec={**cell.spec, "rate": rate})
        _, _, eng, s = harness.serve(c, args.seed, args.seconds, False, dev,
                                     mcfg, params)
        harness.free(eng)
        del eng
        w0, w1 = s.w0, s.w1
        due_w = [r for r in s.recs if w0 <= r.due < w1]
        offered = sum(r.out for r in due_w) / (w1 - w0)

        def backlog(t):
            return sum(1 for r in s.recs if r.due <= t
                       and (r.done is None or r.done > t))
        print(json.dumps({
            "rate": rate, "offered_tok_s": offered,
            "out_tok_s": s.tokens_in_window / (w1 - w0),
            "ttft_p95_ms": window.ttft_p95_ms(s.recs, w0, w1),
            "tpot_p95_ms": window.tpot_p95_ms(s.recs, w0, w1),
            "slo_attain": window.slo_attain(s.recs, w0, w1),
            "backlog_start": backlog(w0), "backlog_end": backlog(w1),
            "due_in_window": len(due_w), "failed": s.failed,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}),
            flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
