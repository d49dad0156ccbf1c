"""Readings that set a cell's limit, on the card, in one process: for each
seed, the cell's own run (pre-roll and window at its load), then the
comparison that decides ``correct`` twice over the same sample: once on
the program's served tokens, once with the control in the program's
place (``harness.control_sample``: the reference with every matrix
product's operands in float8 e4m3 chooses each token after the same
prefix). Not run by the benchmark's own runs.

    python3 econobench/control.py --workload nemo12b.chat --seconds 51 --seeds 11,12,13

Prints one JSON line a seed (the program's check and its ``correct``, the
control's check and its ``correct``), and a summary of the cell's number:
the program's largest (the lower reading) and the control's smallest (the
upper). ``--witness`` adds the gaps of the reference computed with bf16
operands."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from econobench import env  # noqa: E402

env.setup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--witness", action="store_true",
                    help="also the reference with bf16 operands")
    args = ap.parse_args(argv)
    import torch
    from econobench import harness
    cell = harness.load_cell(args.workload)
    ref = harness.load_module(harness.HERE / "references"
                              / f"{cell.conf['reference']}.py")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lows, highs = [], []
    number = cell.spec["check"]["number"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        mcfg, params, eng, served = harness.serve(cell, seed, args.seconds,
                                                  False, dev)
        harness.free(eng)
        del eng
        ok, out = harness.check(cell, mcfg, params, served, seed)
        rcfg = harness.ref_config(mcfg)
        sample = harness.pick(served.done, cell.spec["check"]["requests"],
                              seed)
        ctl = harness.control_sample(ref, rcfg, params, sample)
        c_ok, c_out = harness.check(cell, mcfg, params,
                                    SimpleNamespace(done=ctl), seed)
        line = {"seed": seed, "correct": ok, "check": out,
                "control_correct": c_ok, "control_check": c_out,
                "done": len(served.done)}
        if args.witness:
            line["witness"] = harness.gaps(ref, rcfg, params, sample,
                                           witness=True)
        lows.append(out[number]["value"])
        highs.append(c_out[number]["value"])
        torch.cuda.synchronize()
        line["seconds"] = time.monotonic() - t0
        print(json.dumps(line), flush=True)
        del params
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "number": number,
                      "lower": max(lows), "upper": min(highs),
                      "program": lows, "control": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
