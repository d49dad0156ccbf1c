"""The port's dry-run (``repro_torch.launch.dryrun``), the counterpart of
``tests/test_sharding.py::test_small_mesh_dryrun_subprocess``: in a
subprocess (the fake process group is process-global), reduced qwen3-8b
train, zamba2-7b decode and phi3.5-MoE prefill trace on a fake (4, 4) mesh;
each record's per-device argument bytes equal the local shard sizes that
the sharding rules give, and the steps issue collectives."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.shapes import (ShapeSpec, adapt_config,  # noqa: E402
                                       opt_config_for, serving_fsdp)
from repro_torch.models import model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = (4, 4)
COMBOS = [("qwen3-8b", "train"), ("zamba2-7b", "decode"),
          ("phi3.5-moe-42b-a6.6b", "prefill")]
SHAPES = {"train": ShapeSpec("t", "train", 256, 8),
          "prefill": ShapeSpec("p", "prefill", 256, 8),
          "decode": ShapeSpec("d", "decode", 512, 16)}
_SUBPROC = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec
combos = json.loads(sys.argv[1])
out = {}
with dryrun.fake_world(16):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    for arch, (name, kind, seq, batch) in combos:
        cfg = get_config(arch).reduced(d_model=256).with_(vocab_size=512)
        out[arch] = dryrun.run_one(arch, name, False, verbose=False,
                                   mesh=mesh, cfg=cfg,
                                   shape=ShapeSpec(name, kind, seq, batch))
print("RESULT" + json.dumps(out, default=str))
"""


class StandIn:
    axis_names = ("data", "model")
    devices = np.empty(MESH)


def _local_bytes(shape, spec, itemsize) -> int:
    return math.prod(shd._local_shape(shape, spec, StandIn)) * itemsize


def _expected_argument_bytes(cfg, shape: ShapeSpec) -> int:
    """The local shard bytes of ``build_step``'s arguments under the rules,
    counted from the specs alone."""
    cfg = adapt_config(cfg, shape)
    mesh = StandIn()
    fsdp = shape.kind == "train" or serving_fsdp(cfg, mesh)
    specs = shd.param_specs(cfg, mesh, fsdp=fsdp)
    tree = model.param_tree(cfg)
    psize = model.dtype_of(cfg.param_dtype).itemsize
    n = sum(_local_bytes(m.shape, specs[k], psize) for k, m in tree.items())
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        ssize = model.dtype_of(opt_config_for(cfg).state_dtype).itemsize
        n += 2 * sum(_local_bytes(m.shape, specs[k], ssize)
                     for k, m in tree.items()) + 4          # + step
    if shape.kind in ("train", "prefill"):
        return n + _local_bytes((B, S), ("data", None), 4)
    n += _local_bytes((B, 1), ("data", None), 4) \
        + _local_bytes((B,), ("data",), 4)
    caches = model.init_cache(cfg, B, S, device="meta")
    cspecs = shd.cache_specs(cfg, mesh, batch=B, capacity=S,
                             shard_batch=True, shard_seq=False)
    for kind, sub in caches.items():
        for leaf, t in sub.items():
            n += _local_bytes(t.shape, cspecs[kind][leaf], t.element_size())
    return n


@pytest.fixture(scope="module")
def records():
    combos = [(arch, (k, k, SHAPES[k].seq_len, SHAPES[k].global_batch))
              for arch, k in COMBOS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SUBPROC, json.dumps(combos)],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("arch,kind", COMBOS)
def test_reduced_steps_trace_on_a_4x4_fake_mesh(records, arch, kind):
    rec = records[arch]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 16 and rec["mesh"] == "4x4"
    cfg = get_config(arch).reduced(d_model=256).with_(vocab_size=512)
    assert rec["mem_bytes"]["argument"] == \
        _expected_argument_bytes(cfg, SHAPES[kind])
    assert sum(rec["collective_bytes"].values()) > 0
    m = rec["mem_bytes"]
    assert rec["mem_per_device"] == m["argument"] + m["temp"] \
        + m["output"] - m["alias"]
    assert rec["flops"] > 0 and rec["fits"]
    # the reference's record keys, and the roofline's terms
    assert {"arch", "shape", "mesh", "status", "compile_s", "chips",
            "mem_bytes", "flops", "hlo_bytes", "collective_bytes",
            "roofline_hlo_raw", "roofline", "bottleneck"} <= set(rec)
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    if kind == "decode":
        assert m["alias"] > 0               # the caches, updated in place
