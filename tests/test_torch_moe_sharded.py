"""The port's row-blocked MoE (``moe_apply`` with ``data_shards()`` 2 or
4) held against the reference's row-blocked path on the CPU, in float32,
on the same weights and inputs, at a capacity factor of 0.5 so that rows
drop tokens: the reference runs on a (1, 1) mesh with the data axis
declared 2 or 4 wide (rows that cut across sequences, and a call small
enough to keep one row). Then the expert-parallel ``local_map`` path on a (2, 2) mesh of 4
``gloo`` ranks against the single-process ``D = 2`` result (a prefill-sized
call) and the ``D = 1`` result (a decode-sized call, the decode schedule
over ``data``)."""
import os
import socket
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
RTOL = 1e-5
AXES = ("data", "model")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _layer(cf=0.5):
    jcfg = jax_config("phi3_5_moe_42b").reduced().with_(capacity_factor=cf,
                                                         **F32)
    cfg = get_config("phi3_5_moe_42b").reduced().with_(capacity_factor=cf,
                                                       **F32)
    jp = jmodel.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu", dtype=torch.float32)
    jl = {k[len("A/moe/"):]: v[1] for k, v in jp.items()
          if k.startswith("A/moe/")}
    tl = {k[len("moe."):]: tp[k][1] for k in tp if k.startswith("moe.")}
    return jcfg, cfg, jl, tl


@pytest.mark.parametrize("shape,D", [
    ((2, 32), 2), ((4, 24), 2), ((1, 70), 2),
    # four data shards: a row of 32 tokens is decode-sized (one row),
    # 96 tokens make rows of 24 that cut across sequences, 64 of 16
    ((1, 32), 4), ((3, 32), 4), ((1, 64), 4)])
def test_row_blocked_moe_matches_the_reference(shape, D):
    jcfg, cfg, jl, tl = _layer()
    x = np.random.default_rng(sum(shape)).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    T = shape[0] * shape[1]
    mesh = jax.make_mesh((1, 1), AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    try:
        jcommon.set_mesh_axes(AXES, {"data": D, "model": 1}, mesh)
        common.set_mesh_axes(AXES, {"data": D, "model": 1})
        assert jcommon.data_shards() == common.data_shards() == D
        with mesh:
            y_j, aux_j = jmoe.moe_apply(jl, jcfg, jnp.asarray(x))
        y_t, aux_t = moe.moe_apply(tl, cfg, torch.from_numpy(x))
    finally:
        jcommon.set_mesh_axes(())
        common.set_mesh_axes(())
    assert _rel(y_t, y_j) <= RTOL
    assert _rel(aux_t, aux_j) <= RTOL
    # each row of T / D tokens has its own capacity, and some rows drop
    rows = D if T % D == 0 and T >= 16 * D else 1
    Cl = moe.capacity(cfg, T // rows)
    assert Cl == jmoe.capacity(jcfg, T // rows)
    probs = torch.softmax(torch.from_numpy(x).reshape(rows, T // rows, -1)
                          @ tl["router"], dim=-1)
    _, idx = moe.top_k(probs, cfg.experts_per_token)
    loads = [np.bincount(r.ravel(), minlength=cfg.num_experts).max()
             for r in idx.numpy()]
    assert max(loads) > Cl
    # and the rows differ from one global capacity
    y_1, _ = moe.moe_apply(tl, cfg, torch.from_numpy(x))
    assert torch.allclose(y_1, y_t) == (rows == 1)


# --------------------------------------------------------------------------- #
# the expert-parallel path on a (2, 2) gloo mesh
# --------------------------------------------------------------------------- #
CALLS = {"prefill": (2, 32), "decode": (4, 1)}


def _worker(rank: int, port: int, queue) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from repro_torch.distributed import sharding as shd
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
        _, cfg, _, tl = _layer()
        specs = {k: shd.spec_for_axes(m.axes)
                 for k, m in moe.moe_params(cfg).items()}
        dl = {k: shd.shard_tensor(t, specs[k], mesh) for k, t in tl.items()}
        out = {}
        for name, shape in CALLS.items():
            x = torch.from_numpy(np.random.default_rng(sum(shape))
                                 .standard_normal((*shape, cfg.d_model))
                                 .astype(np.float32))
            try:
                common.set_mesh_axes(AXES, {"data": 2, "model": 2}, mesh)
                with implicit_replication():
                    y, aux = moe.moe_apply(dl, cfg, shd.shard_tensor(
                        x, ("data", None, None), mesh))
                y, aux = y.full_tensor(), aux.full_tensor()
                common.set_mesh_axes(AXES, {"data": 2, "model": 2})
                y_ref, aux_ref = moe.moe_apply(tl, cfg, x)
            finally:
                common.set_mesh_axes(())
            out[name] = (_rel(y, y_ref), _rel(aux, aux_ref))
        queue.put((rank, out))
    except Exception:  # noqa: BLE001 — report the rank's failure
        queue.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def test_expert_parallel_path_matches_one_process():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    env = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_worker, args=(r, port, queue))
                 for r in range(4)]
        for p in procs:
            p.start()
        got = dict(queue.get(timeout=90) for _ in procs)
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive()
    finally:
        os.environ.clear()
        os.environ.update(env)
    for rank, out in got.items():
        assert isinstance(out, dict), f"rank {rank}:\n{out}"
        for name, errs in out.items():
            assert max(errs) <= RTOL, (rank, name, errs)
