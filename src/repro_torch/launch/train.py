"""Training launcher of the PyTorch port, on one device: seeded random
weights, the synthetic data, AdamW, and an optional checkpoint in the
reference's layout.

Usage:
  python -m repro_torch.launch.train --arch qwen3-8b --steps 50 --reduced
  python -m repro_torch.launch.train --arch qwen3-8b --reduced --steps 3 \\
      --device cpu --save build/ckpt.msgpack

``--reduced`` trains the float32 smoke variant of the family, as the
reference's launcher does; without it the published config trains at its
published dtypes. Runs on the card unless ``--device cpu`` is given.

``--data-axis``/``--model-axis`` above 1 train on a (data, model)
``DeviceMesh`` of that many processes, one per rank, started by
``torchrun`` (``nccl`` on the cards, ``gloo`` with ``--device cpu``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-8b \
      --reduced --steps 2 --device cpu --data-axis 2 --model-axis 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import set_mesh_axes
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def _mesh(args):
    """The (data, model) mesh over this process group (joined from
    ``torchrun``'s environment when none exists), its axes declared."""
    import torch.distributed as dist
    n = args.data_axis * args.model_axis
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"a {args.data_axis}x{args.model_axis} mesh "
                               f"needs {n} processes: run under torchrun "
                               f"--nproc-per-node {n}")
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    if dist.get_world_size() != n:
        raise ValueError(f"a {args.data_axis}x{args.model_axis} mesh needs "
                         f"{n} processes, not {dist.get_world_size()}")
    if args.device != "cpu":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    mesh = make_host_mesh(args.data_axis, args.model_axis,
                          "cpu" if args.device == "cpu" else "cuda")
    set_mesh_axes(mesh.mesh_dim_names, {"data": args.data_axis,
                                        "model": args.model_axis}, mesh)
    return mesh


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
    mesh = None
    if args.data_axis * args.model_axis > 1:
        mesh = _mesh(args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().with_(dtype="float32", param_dtype="float32")
    t0 = time.time()

    def log(i, m):
        print(f"step {i:5d} loss={m['loss']:.6f} "
              f"gnorm={m['grad_norm']:.3f} ({time.time() - t0:.1f}s)",
              flush=True)

    try:
        params, opt_state, _ = train(
            cfg, args.steps, opt=AdamWConfig(lr=args.lr),
            batch_size=args.batch, seq_len=args.seq, seed=0, log_every=10,
            callback=log, device=args.device, mesh=mesh)
    finally:
        set_mesh_axes(())
    if args.save:
        checkpoint.save(args.save, params, meta={"step": np.asarray(
            args.steps)})
        print(f"saved {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
