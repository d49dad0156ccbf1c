"""Run one cell of the benchmark once, on the card of this machine.

    python3 econobench/run.py --workload nemo12b.chat --seed 7 --seconds 40 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` and ``live`` (``--trace 1``: what the decode rows held,
beside ``memory_peak_bytes``) and last ``check``: each number compared,
with its limit, also printed as the last lines of standard error. Exits
with 2, printing no result, without a CUDA card, or with fewer cards than
the cell asks for, or without the port beside it; with 3 if a module of
JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from econobench import env  # noqa: E402

env.setup()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"econobench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    if not (env.ROOT / "src" / "repro_torch").is_dir():
        return fail("the port (src/repro_torch) is not in this checkout", 2)
    from econobench import harness
    cell = harness.load_cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} CUDA card(s); "
                    f"{torch.cuda.device_count()} present", 2)
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mcfg, params, eng, served = harness.serve(
        cell, args.seed, args.seconds, bool(args.trace), dev)
    setup_s = served.w0 - T_START
    torch.cuda.synchronize()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    result = {}
    if args.trace:
        metrics, prof = harness.per_layer(cell, served, mcfg)
        device["busy_s"] = prof.busy_s
        device["window_s"] = prof.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in prof.top_ops],
                               "idle_gaps": [list(x) for x in
                                             prof.idle_gaps]}
        result["live"] = harness.live(served, mcfg)
        served.prof = None
    else:
        metrics = harness.end_to_end(cell, served, setup_s)
    harness.free(eng)
    del eng
    ok, check = harness.check(cell, mcfg, params, served, args.seed)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        return fail(f"modules of JAX or of the JAX package loaded: {bad}", 3)
    out = {"correct": ok, "attempted": served.attempted,
           "failed": served.failed, "metrics": metrics, "device": device}
    out.update(result)
    out["check"] = check
    for name, v in check.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
