"""Serving launcher of the PyTorch port: continuous batching on one engine
under the EconoServe scheduler, with seeded random weights.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-8b --requests 12
  python -m repro_torch.launch.serve --arch qwen3-8b --full --capacity 2048
  python -m repro_torch.launch.serve --device cpu --requests 4

The default config mirrors ``.reduced()`` in float32; ``--full`` keeps the
published widths and depth (bf16). The engine runs on the card unless
``--device cpu`` is given. The reference launcher's ``--sim`` and
``--cluster`` modes are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving import GenRequest, SamplingParams, ServingEngine


def run_engine(args) -> int:
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced().with_(dtype="float32", param_dtype="float32")
    server = ServingEngine(cfg, max_batch=args.max_batch,
                           capacity=args.capacity, variant=args.variant,
                           seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [GenRequest(
        prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(4, args.capacity // 4)))],
        params=SamplingParams(max_new_tokens=int(rng.integers(4, 24))))
        for _ in range(args.requests)]
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    toks = sum(len(g.output) for g in reqs)
    done = sum(g.t_done is not None for g in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {server.device}, arch={cfg.name}, "
          f"layers={cfg.num_layers}, d_model={cfg.d_model})")
    return 0 if done == len(reqs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: .reduced())")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    return run_engine(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
