"""Multi-node dry-run on the host: trace every (arch x shape x mesh) combo's
step, as ``build_step`` gives it, on the production mesh of 256 (512)
H100s, with no card and no memory: a ``fake`` process group of that many
ranks (this process is rank 0), ``FakeTensorMode`` tensors, and a mesh of
device type ``cuda`` where PyTorch has CUDA (``mesh_device``). Prints
per-device memory and the roofline terms, and dumps each record to JSON
with the reference's keys (``repro.launch.dryrun``).

What a record holds, per device (rank 0; the rules shard evenly):
  mem_bytes.argument  bytes of the step's arguments (local shards)
  mem_bytes.output    bytes of its outputs
  mem_bytes.alias     output bytes that are arguments updated in place
                      (the reference's donated buffers)
  mem_bytes.temp      the trace's peak of bytes allocated beyond the
                      arguments, less the new outputs
  mem_per_device      argument + temp + output - alias; ``fits`` says
                      whether it fits an H100's 80 GB
  collective_bytes    result bytes of every functional collective the rank
                      issues (all-reduce, all-gather, reduce-scatter,
                      all-to-all), counted by a dispatch mode
  flops / hlo_bytes   the trace's matmul FLOPs and bytes written per rank
                      (the attention kernels' own work not included)
  roofline            ``analytic.analytic_roofline`` with the counted
                      collective bytes; ``bottleneck`` its largest term

The fake process group is process-global: run the dry-run before any
other ``init_process_group`` in the process; it is torn down afterwards.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

A combo whose trace outlasts ``TRACE_SECONDS`` is recorded as ``fail``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import analytic
from repro_torch.launch.shapes import SHAPES, ShapeSpec, applicable, \
    build_step

CARD_BYTES = 80e9            # one H100's HBM
TRACE_SECONDS = 600.0        # a combo's trace time before it is a fail
# functional collectives -> the reference's (XLA's) collective kinds
_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}
_MATMULS = ("mm", "addmm", "bmm", "baddbmm")


def mesh_device() -> str:
    """The device type of the traced mesh: ``cuda`` where PyTorch has CUDA
    (fake tensors need no card), else ``cpu``. On a ``cpu`` mesh DTensor
    lowers a shard-to-shard move (an all-to-all under NCCL) to an
    all-gather and a slice, so its all-gather bytes are an upper bound."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run installs its own fake process "
                           "group: run it before init_process_group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_storages(tree):
    """The storages of the local shards of a tree's tensors."""
    for t in _leaves(tree):
        yield (t.to_local() if hasattr(t, "to_local") else t) \
            .untyped_storage()


def _storages(tree) -> Dict[int, int]:
    """{storage id: bytes} of the local shards of a tree's tensors."""
    return {st._cdata: st.nbytes() for st in _local_storages(tree)}


def _in_sharding_propagation() -> bool:
    """Whether DTensor's planner is running an op on global-shape fake
    tensors to learn its output's shape (no allocation of a real run)."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            return False
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def _make_trace_mode(args):
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.weak import WeakIdKeyDictionary

    class StepTrace(TorchDispatchMode):
        """Sees each rank-local op (DTensor ops are let through to DTensor
        first, which lowers them to local ops and collectives): sums the
        result bytes of each collective by kind, the FLOPs of matmuls and
        the bytes every op writes, and tracks the bytes of live storages
        the step allocates (their peak); the arguments' storages, and
        views and in-place results on them, are not allocations."""

        def __init__(self, args):
            super().__init__()
            self.collectives: Dict[str, int] = {}
            self.flops = 0
            self.written = 0
            self.live = self.peak = 0
            self._seen = WeakIdKeyDictionary()
            for st in _local_storages(args):     # not allocated by the step
                self._seen[st] = 0

        def _free(self, n: int) -> None:
            self.live -= n

        def _track(self, t: torch.Tensor) -> None:
            st = t.untyped_storage()
            if st in self._seen:
                return
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if _in_sharding_propagation():
                return out
            name = getattr(func, "_overloadpacket", func).__name__
            outs = list(_leaves(out))
            if name in _KINDS and outs:
                kind = _KINDS[name]
                self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                    o.numel() * o.element_size() for o in outs)
            if name in _MATMULS:
                a, b = args[-2], args[-1]
                self.flops += 2 * a.numel() * b.shape[-1]
            for o in outs:
                self.written += o.numel() * o.element_size()
                self._track(o)
            return out

    return StepTrace(args)


def trace_step(cfg, shape: ShapeSpec, mesh) -> Dict:
    """Trace one step of ``build_step`` on ``mesh`` under FakeTensorMode;
    returns the record's measured fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    from repro_torch.models.common import set_mesh_axes
    try:
        # a shape environment lets DTensor's planner read the offsets of a
        # strided shard (a flatten of two sharded dims) as symbols, where
        # a bare fake mode refuses the data-dependent read
        with FakeTensorMode(allow_non_fake_inputs=True,
                            shape_env=ShapeEnv()):
            step, args, kw = build_step(cfg, shape, mesh, device="cpu")
            arg_st = _storages(args)
            tr = _make_trace_mode(args)
            with tr:
                out = step(*args)
            out_st = _storages(out)
    finally:
        set_mesh_axes(())
    argument = sum(arg_st.values())
    output = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    new_out = output - alias
    temp = max(0, tr.peak - new_out)
    return {"mem_bytes": {"argument": argument, "output": output,
                          "temp": temp, "alias": alias},
            "mem_per_device": argument + temp + output - alias,
            "flops": float(tr.flops), "hlo_bytes": float(tr.written),
            "collective_bytes": dict(tr.collectives),
            "donate_argnums": list(kw.get("donate_argnums", ()))}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: Optional[str] = None, verbose: bool = True,
            mesh=None, cfg=None, shape: Optional[ShapeSpec] = None) -> Dict:
    """One combo on the production mesh (or on ``mesh``, with ``cfg`` and
    ``shape`` in place of the registry's), inside a fake world."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    ok, reason = applicable(cfg, shape)
    from repro_torch.distributed.sharding import axis_sizes
    mesh_name = "x".join(map(str, axis_sizes(mesh).values())) if mesh \
        else ("2x32x8" if multi_pod else "32x8")
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "mesh_device": mesh.device_type if mesh else mesh_device()}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    if mesh is None:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=mesh_device())
    n_chips = mesh.size()
    t0 = time.time()
    try:
        rec.update(trace_step(cfg, shape, mesh))
        rec.update(status="ok", compile_s=round(time.time() - t0, 1),
                   chips=int(n_chips))
        coll_total = float(sum(rec["collective_bytes"].values()))
        rec["roofline_hlo_raw"] = {
            "compute_s": rec["flops"] / analytic.PEAK_FLOPS,
            "memory_s": rec["hlo_bytes"] / analytic.HBM_BW,
            "collective_s": coll_total / analytic.LINK_BW,
        }
        ana = analytic.analytic_roofline(
            cfg, shape, collective_bytes_per_chip=coll_total,
            chips=int(n_chips))
        rec["roofline"] = ana.as_dict()
        rec["bottleneck"] = ana.bottleneck
        rec["fits"] = rec["mem_per_device"] <= CARD_BYTES
        if verbose:
            print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:8s} OK "
                  f"trace={rec['compile_s']:6.1f}s "
                  f"mem/dev={rec['mem_per_device'] / 1e9:7.2f}GB "
                  f"fits80GB={rec['fits']} "
                  f"bottleneck={rec['bottleneck']}", flush=True)
            print(f"  mem_bytes: {rec['mem_bytes']} coll="
                  f"{rec['collective_bytes']} roofline={rec['roofline']}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:8s} "
                  f"FAIL {rec['error'][:300]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch.replace('/', '_')}_{shape_name}_{mesh_name}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


@contextmanager
def _time_limit(seconds: Optional[float]):
    """Raise ``TimeoutError`` in this (main) thread after ``seconds``."""
    if not seconds:
        yield
        return
    import signal

    def expire(signum, frame):
        raise TimeoutError(f"the trace took longer than {seconds:g} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def sweep(archs, shapes, meshes, out_dir=None, verbose=True,
          time_limit: Optional[float] = None):
    """Every (arch, shape) on each mesh, one fake world per mesh; a combo
    whose trace outlasts ``time_limit`` seconds is recorded as ``fail``."""
    recs = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    with _time_limit(time_limit):
                        recs.append(run_one(arch, shape, mp,
                                            out_dir=out_dir,
                                            verbose=verbose))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs(include_paper_model=False) if args.arch is None \
        else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if not args.all and args.arch is None and args.shape is None:
        ap.error("pass --all or --arch/--shape")

    recs = sweep(archs, shapes, meshes, out_dir=args.out,
                 time_limit=TRACE_SECONDS)
    n_fail = sum(r["status"] == "fail" for r in recs)
    print(f"[dryrun] done, failures={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
