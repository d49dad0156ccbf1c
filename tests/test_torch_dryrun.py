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


# --------------------------------------------------------------------------- #
# the sLSTM scan under fake tensors (xlstm-125m's prefill_32k)
# --------------------------------------------------------------------------- #
def _slstm_inputs(cfg, S: int, seed: int = 0):
    import torch
    from repro_torch.models import xlstm
    from repro_torch.models.common import init_params
    gen = torch.Generator().manual_seed(seed)
    p = init_params(xlstm.slstm_params(cfg), gen, torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model))
                         .astype(np.float32))
    return p, x


def test_slstm_prefill_traces_32k_steps_once_under_fake_tensors():
    """The dry-run's xlstm-125m prefill_32k: the scan traces its body once
    (as ``lax.scan`` does), so a 32768-step sLSTM layer traces in seconds
    and gives the real call's shapes and dtypes."""
    import time
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import xlstm
    cfg = get_config("xlstm-125m")
    S = 32768
    t0 = time.monotonic()
    with FakeTensorMode():
        p = {k: torch.empty(m.shape) for k, m in
             xlstm.slstm_params(cfg).items()}
        y, st = xlstm.slstm_prefill(p, cfg, torch.empty(1, S, cfg.d_model))
    assert time.monotonic() - t0 < 30
    di = xlstm._dims(cfg)[0]
    assert tuple(y.shape) == (1, S, cfg.d_model) and y.dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in st.items()} == {
        k: (1, di) for k in ("c", "n", "h", "m")}


def test_slstm_prefill_real_tensors_keep_the_loop():
    """Real tensors still run every step: the output and state equal a
    plain loop of ``_slstm_step``, and the fake trace of the same call has
    their shapes and dtypes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import xlstm
    from repro_torch.models.common import rms_norm
    cfg = get_config("xlstm-125m").reduced()
    S = 37
    p, x = _slstm_inputs(cfg, S)
    y, st = xlstm.slstm_prefill(p, cfg, x)
    state = xlstm.slstm_init_cache(cfg, 2)
    hs = []
    for t in range(S):
        state = xlstm._slstm_step(p, cfg, (x @ p["w_in"])[:, t], state)
        hs.append(state["h"])
    want = rms_norm(torch.stack(hs, 1), p["out_norm"], cfg.rms_eps) \
        @ p["down"]
    torch.testing.assert_close(y, want, atol=0, rtol=0)
    for k in ("c", "n", "h", "m"):
        torch.testing.assert_close(st[k], state[k], atol=0, rtol=0)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fy, fst = xlstm.slstm_prefill(
            {k: mode.from_tensor(v) for k, v in p.items()}, cfg,
            mode.from_tensor(x))
    assert fy.shape == y.shape and fy.dtype == y.dtype
    assert {k: (v.shape, v.dtype) for k, v in fst.items()} == {
        k: (v.shape, v.dtype) for k, v in st.items()}
