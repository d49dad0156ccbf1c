"""Training launcher of the PyTorch port, on one device: seeded random
weights, the synthetic data, AdamW, and an optional checkpoint in the
reference's layout.

Usage:
  python -m repro_torch.launch.train --arch qwen3-8b --steps 50 --reduced
  python -m repro_torch.launch.train --arch qwen3-8b --reduced --steps 3 \\
      --device cpu --save build/ckpt.msgpack

``--reduced`` trains the float32 smoke variant of the family, as the
reference's launcher does; without it the published config trains at its
published dtypes. Runs on the card unless ``--device cpu`` is given. A
data or model axis above 1 needs the sharding slice of the port (ROADMAP.md,
queue 1, item 2) and is refused.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the family")
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args(argv)
    if args.data_axis * args.model_axis > 1:
        raise NotImplementedError(
            "--data-axis/--model-axis above 1 need sharded training, which "
            "the port does not have yet (ROADMAP.md, queue 1, item 2: "
            "sharding and launch)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().with_(dtype="float32", param_dtype="float32")
    t0 = time.time()

    def log(i, m):
        print(f"step {i:5d} loss={m['loss']:.4f} "
              f"gnorm={m['grad_norm']:.3f} ({time.time() - t0:.1f}s)",
              flush=True)

    params, opt_state, _ = train(
        cfg, args.steps, opt=AdamWConfig(lr=args.lr),
        batch_size=args.batch, seq_len=args.seq, seed=0, log_every=10,
        callback=log, device=args.device)
    if args.save:
        checkpoint.save(args.save, params, meta={"step": np.asarray(
            args.steps)})
        print(f"saved {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
