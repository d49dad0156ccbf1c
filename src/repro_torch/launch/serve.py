"""Serving launcher of the PyTorch port: continuous batching under any
scheduler in the registry, on one engine or an N-instance fleet
(``--cluster N``) with SLO-aware routing and optional disaggregated
prefill/decode roles (``--disagg``), with seeded random weights; or the
trace-driven simulator (``--sim``), which runs no model.

Usage:
  python -m repro_torch.launch.serve --requests 12
  python -m repro_torch.launch.serve --full --capacity 2048
  python -m repro_torch.launch.serve --arch qwen3-8b --cluster 2 --disagg
  python -m repro_torch.launch.serve --device cpu --requests 4
  python -m repro_torch.launch.serve --sim --trace sharegpt \
      --requests 500 --rate 5.0 --scheduler econoserve --cluster 4

The model is opt-13b, the paper's own serving model, unless ``--arch``
names another (the reference's default). The default config mirrors
``.reduced()`` in float32; ``--full`` keeps the published widths and depth
(bf16). Engines and fleets run on the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.cluster import EngineFleet, ROUTERS
from repro_torch.configs import get_config
from repro_torch.core import registry, traces
from repro_torch.core.costmodel import CostModel, ModelProfile
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.serving import GenRequest, SamplingParams, ServingEngine


def _roles(args):
    if not args.disagg:
        return None
    assert args.cluster >= 2, "--disagg needs --cluster >= 2"
    return ["prefill"] + ["decode"] * (args.cluster - 1)


def run_engine(args) -> int:
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced().with_(dtype="float32", param_dtype="float32")
    kw = dict(max_batch=args.max_batch, capacity=args.capacity,
              variant=args.variant, device=args.device)
    if args.cluster:
        server = EngineFleet(cfg, n_instances=args.cluster,
                             roles=_roles(args), router=args.router,
                             seed=args.seed, **kw)
    else:
        server = ServingEngine(cfg, seed=args.seed, **kw)
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
    mode = f"cluster={args.cluster} router={args.router}" if args.cluster \
        else "single"
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {server.device}, arch={cfg.name}, "
          f"layers={cfg.num_layers}, d_model={cfg.d_model}, {mode})")
    if args.cluster:
        cons = server.conservation()
        print(f"conservation: {cons}")
        if not cons["ok"]:
            return 1
    return 0 if done == len(reqs) else 1


def run_sim(args) -> int:
    spec = traces.TRACES[args.trace]
    reqs = traces.generate(spec, args.requests, seed=args.seed,
                           rate=args.rate)
    cost = CostModel(model=ModelProfile.from_config(get_config(args.arch)))
    if args.cluster:
        res = registry.run_cluster(args.scheduler, reqs,
                                   n_instances=args.cluster,
                                   router=args.router, roles=_roles(args),
                                   cfg=SchedulerConfig(), cost=cost,
                                   seed=args.seed)
        print(f"cluster x{args.cluster} router={args.router} "
              f"roles={'disagg' if args.disagg else 'unified'}")
        print(f"{'goodput_req_s':26s} {res.goodput:.4f}")
        print(f"{'throughput_req_s':26s} {res.throughput_reqs:.4f}")
        print(f"{'ssr':26s} {res.ssr:.4f}")
        print(f"{'migrations':26s} {res.n_migrations}")
        print(f"conservation: {res.conservation()}")
        return 0 if res.conservation()["ok"] else 1
    res = registry.run_one(args.scheduler, reqs, SchedulerConfig(), cost)
    for k, v in res.summary().items():
        print(f"{k:26s} {v:.4f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-13b")
    ap.add_argument("--sim", action="store_true",
                    help="trace-driven simulation instead of the engine")
    ap.add_argument("--scheduler", default="econoserve",
                    choices=registry.SCHEDULERS)
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: .reduced())")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--trace", default="sharegpt", choices=list(traces.TRACES))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="serve across N instances (0 = single engine)")
    ap.add_argument("--router", default="least-kvc", choices=list(ROUTERS))
    ap.add_argument("--disagg", action="store_true",
                    help="instance 0 prefills, the rest decode (KV "
                         "migration); requires --cluster >= 2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run_sim(args) if args.sim else run_engine(args)


if __name__ == "__main__":
    raise SystemExit(main())
