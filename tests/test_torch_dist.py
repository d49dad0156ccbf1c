"""The port's sharded steps on a (2, 2) mesh of 4 CPU ``gloo`` ranks, held
against the same steps in one process without a mesh, in float32: reduced
qwen3 (train, prefill, decode; a prefill of 1 row, which the 2 data ranks
do not divide, and one of 2 rows on a (pod 2, data 2, model 1) mesh of the
same ranks), reduced zamba2 (decode and train: the
chunked SSD as a region), reduced xlstm (train: the mLSTM chunks and the
sLSTM scan as regions) and reduced
phi3.5-MoE (prefill, decode, its expert-parallel ``local_map`` path against
the single-process row-blocked ``D = 2`` path), each through
``launch.shapes.build_step``; and the train launcher on that mesh against
its 1x1 run. One ``torch.multiprocessing`` spawn of 4 ranks, one torch
thread each."""
import contextlib
import io
import os
import re
import socket
import traceback

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 4
RTOL = 1e-5
F32 = dict(dtype="float32", param_dtype="float32")
# (name, arch, shape kind, seq, batch): every step at a (2, 2) mesh's sizes
CASES = [
    ("qwen3_train", "qwen3-8b", "train", 32, 4),
    ("qwen3_prefill", "qwen3-8b", "prefill", 32, 4),
    ("qwen3_decode", "qwen3-8b", "decode", 64, 4),
    ("zamba2_decode", "zamba2-7b", "decode", 64, 4),
    ("zamba2_train", "zamba2-7b", "train", 32, 4),
    ("xlstm_train", "xlstm-125m", "train", 32, 4),
    ("moe_prefill", "phi3.5-moe-42b-a6.6b", "prefill", 32, 2),
    ("moe_decode", "phi3.5-moe-42b-a6.6b", "decode", 64, 4),
    ("moe_train", "phi3.5-moe-42b-a6.6b", "train", 32, 4),
    # batches the 2 data ranks do not divide: prefill and train pad each
    # rank's rows (1 row: one real row and one pad row; 3 rows: a rank of
    # 2 real rows, one of a real and a pad row); a decode keeps its cache
    # rows whole on every rank
    ("qwen3_prefill_batch1", "qwen3-8b", "prefill", 32, 1),
    ("qwen3_train_batch3", "qwen3-8b", "train", 32, 3),
    ("qwen3_decode_batch3", "qwen3-8b", "decode", 64, 3),
]
# the same on a (pod 2, data 2, model 1) mesh built in the same spawn:
# 2 rows over 4 batch ranks, two of which hold only pad rows
POD_CASES = [("qwen3_prefill_pod_batch2", "qwen3-8b", "prefill", 32, 2)]
LAUNCH = ["--arch", "qwen3-8b", "--reduced", "--steps", "2", "--batch", "4",
          "--seq", "32", "--device", "cpu"]


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_full(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        full = getattr(tree, "full_tensor", None)
        return (full() if full else tree).detach().clone()
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _worst(a, b, whole: bool = False) -> float:
    """The largest difference of two output trees over the largest
    magnitude of each leaf (of the whole tree with ``whole``); integer
    leaves must be equal."""
    pairs = list(zip(_flat(a), _flat(b)))
    top = max((float(y.detach().abs().max()) for _, y in (p[1] for p in
                                                          pairs)
               if y.is_floating_point()), default=0.0)
    worst = 0.0
    for (name, x), (_, y) in pairs:
        assert x.shape == y.shape, name
        if not x.is_floating_point():
            assert torch.equal(x, y), name
            continue
        x, y = x.detach(), y.detach()
        scale = max(top if whole else float(y.abs().max()), 1e-30)
        worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def _case(mesh, arch, kind, seq, batch) -> float:
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import ShapeSpec, build_step
    from repro_torch.models.common import set_mesh_axes
    cfg = get_config(arch).reduced().with_(**F32)
    step, args, _ = build_step(cfg, ShapeSpec("t", kind, seq, batch), mesh,
                               device="cpu", seed=0)
    plain = _full(args)
    out = _full(step(*args))
    # one process, no mesh; the MoE keeps the mesh's two data rows
    set_mesh_axes(("data", "model"), {"data": 2, "model": 2}, mesh=None)
    ref = step(*plain)
    set_mesh_axes(())
    if kind == "train":
        # AdamW's first step moves a param by about lr * sign(g), so a
        # rounding-level change of a gradient near zero moves the new param
        # by up to twice lr: the metrics and the moments (m = (1 - b1) g
        # after one step) hold the gradients instead, each moment against
        # the largest of its kind (a leaf whose gradient is a cancelling
        # sum, as Mamba2's A_log, is tiny against the rest)
        return max(_worst(out[2], ref[2]), *(
            _worst(out[1][k], ref[1][k], whole=True) for k in ("m", "v")))
    return _worst(out, ref)


def _launch(argv) -> list:
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launch_train.main(argv) == 0
    return [float(x) for x in re.findall(r"loss=([0-9.]+)", buf.getvalue())]


def _worker(rank: int, port: int, queue) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {name: _case(mesh, *spec) for name, *spec in CASES}
        pod = init_device_mesh("cpu", (2, 2, 1),
                               mesh_dim_names=("pod", "data", "model"))
        out.update({name: _case(pod, *spec) for name, *spec in POD_CASES})
        out["launch_2x2"] = _launch(LAUNCH + ["--data-axis", "2",
                                              "--model-axis", "2"])
        out["launch_1x1"] = _launch(LAUNCH)
        queue.put((rank, out))
    except Exception:  # noqa: BLE001 — report the rank's failure
        queue.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results():
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    env = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(r, port, queue))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        got = dict(queue.get(timeout=120) for _ in procs)
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive()
    finally:
        os.environ.clear()
        os.environ.update(env)
    for rank, out in got.items():
        assert isinstance(out, dict), f"rank {rank}:\n{out}"
    return got


@pytest.mark.parametrize("name", [c[0] for c in CASES + POD_CASES])
def test_sharded_step_equals_one_process(results, name):
    for rank, out in results.items():
        assert out[name] <= RTOL, (rank, out[name])


def test_launcher_on_a_2x2_mesh_equals_1x1(results):
    for rank, out in results.items():
        assert len(out["launch_2x2"]) == 2
        for a, b in zip(out["launch_2x2"], out["launch_1x1"]):
            assert abs(a - b) <= RTOL * abs(b), (rank, a, b)
