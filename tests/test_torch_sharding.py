"""The port's sharding rules (``repro_torch.distributed.sharding``) held
against the reference's (``repro.distributed.sharding``) on stand-in meshes
(an object with ``axis_names`` and ``devices``, all either reads), for
every config of the registry: the logical axes of every parameter, the
per-tensor specs of ``spec_for_axes``, ``param_specs`` (FSDP on and off)
and ``cache_specs`` entry for entry; ``model.abstract`` against the
reference's ``jax.eval_shape`` shapes; the analytic roofline terms once
the per-card constants are divided out; and the mesh hooks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import dtensor  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import analytic, shapes  # noqa: E402
from repro_torch.models import common, model  # noqa: E402
from repro_torch.models.weights import JAX_TO_PORT  # noqa: E402

ARCHS = list_archs(include_paper_model=False)
MESHES = {(1, 1): ("data", "model"), (4, 4): ("data", "model"),
          (16, 16): ("data", "model"), (32, 8): ("data", "model"),
          (2, 32, 8): ("pod", "data", "model")}
# (batch, capacity, shard_batch, shard_seq): decode_32k's and long_500k's
CACHES = [(128, 32768, True, False), (1, 524288, False, True)]


class StandIn:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _mesh_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_abstract_shapes_equal_the_reference(arch):
    jtree = jmodel.param_tree(jax_config(arch))
    tree = model.param_tree(get_config(arch))
    assert {JAX_TO_PORT[k] for k in jtree} == set(tree)
    axes = common.param_axes(tree)
    jabs = jax.eval_shape(lambda: jmodel.abstract(jax_config(arch)))
    abstract = model.abstract(get_config(arch))
    for k, m in jtree.items():
        name = JAX_TO_PORT[k]
        assert axes[name] == m.axes, k
        assert tuple(abstract[name].shape) == tuple(jabs[k].shape), k
        assert abstract[name].device.type == "meta"
        assert str(abstract[name].dtype).split(".")[-1] == \
            str(jabs[k].dtype), k


def test_spec_for_axes_equals_the_reference():
    names = [common.VOCAB, common.EMBED, common.HEADS, common.KV, common.MLP,
             common.EXPERT, common.INNER, common.STATE, common.LAYER,
             common.NUL]
    rng = np.random.default_rng(0)
    combos = {(a,) for a in names} | {(a, b) for a in names for b in names}
    combos |= {tuple(rng.choice(len(names), 3)) for _ in range(200)}
    for combo in sorted(combos, key=str):
        axes = tuple(names[i] if isinstance(i, (int, np.integer)) else i
                     for i in combo)
        for fsdp in (True, False):
            assert shd.spec_for_axes(axes, fsdp=fsdp) == \
                tuple(jshd.spec_for_axes(axes, fsdp=fsdp)), axes


@pytest.mark.parametrize("shape", list(MESHES), ids=_mesh_id)
def test_param_and_cache_specs_equal_the_reference(shape):
    mesh = StandIn(shape, MESHES[shape])
    for arch in ARCHS:
        jcfg, cfg = jax_config(arch), get_config(arch)
        for fsdp in (True, False):
            want = jshd.param_specs(jcfg, mesh, fsdp=fsdp)
            got = shd.param_specs(cfg, mesh, fsdp=fsdp)
            assert {JAX_TO_PORT[k] for k in want} == set(got)
            for k, spec in want.items():
                assert got[JAX_TO_PORT[k]] == tuple(spec), (arch, k, fsdp)
        for batch, cap, sb, ss in CACHES:
            want = jshd.cache_specs(jcfg, mesh, batch=batch, capacity=cap,
                                    shard_batch=sb, shard_seq=ss)
            got = shd.cache_specs(cfg, mesh, batch=batch, capacity=cap,
                                  shard_batch=sb, shard_seq=ss)
            assert set(got) == set(want), arch
            for kind in want:
                assert set(got[kind]) == set(want[kind]), (arch, kind)
                for leaf, spec in want[kind].items():
                    assert got[kind][leaf] == tuple(spec), (arch, kind, leaf)
        assert shd.batch_axes(mesh) == tuple(jshd.batch_axes(mesh))


def test_cache_spec_tree_matches_init_cache():
    mesh = StandIn((4, 4), MESHES[(4, 4)])
    for arch in ARCHS:
        cfg = get_config(arch)
        caches = model.init_cache(cfg, 8, 64, device="meta")
        specs = shd.cache_specs(cfg, mesh, batch=8, capacity=64,
                                shard_batch=True, shard_seq=False)
        assert set(specs) == set(caches), arch
        for kind, sub in caches.items():
            assert set(specs[kind]) == set(sub), (arch, kind)
            for leaf, t in sub.items():
                assert len(specs[kind][leaf]) == t.dim(), (arch, kind, leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_the_reference_but_for_the_card(arch):
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        ok, why = shapes.applicable(get_config(arch), shape)
        assert (ok, why) == jshapes.applicable(jax_config(arch), jshape)
        got = analytic.analytic_roofline(
            get_config(arch), shape, collective_bytes_per_chip=3.0e9)
        want = janalytic.analytic_roofline(
            jax_config(arch), jshape, collective_bytes_per_chip=3.0e9)
        for term, const, jconst in (
                ("compute_s", analytic.PEAK_FLOPS, janalytic.PEAK_FLOPS),
                ("memory_s", analytic.HBM_BW, janalytic.HBM_BW),
                ("collective_s", analytic.LINK_BW, janalytic.LINK_BW)):
            a = getattr(got, term) * const
            b = getattr(want, term) * jconst
            assert a == pytest.approx(b, rel=1e-12), (name, term)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert dtensor.placements_for((("pod", "data"), None, "model"), names) \
        == [Shard(0), Shard(0), Shard(2)]
    assert dtensor.placements_for((None, "data"), names) == \
        [Replicate(), Shard(1), Replicate()]


def test_mesh_hooks_are_no_ops_without_a_mesh():
    x = torch.ones(4, 3)
    assert common.data_shards() == 1
    assert common.maybe_constrain(x, common.BATCH_AXES, None) is x
    try:
        common.set_mesh_axes(("pod", "data", "model"),
                             {"pod": 2, "data": 4, "model": 8})
        assert common.data_shards() == 8
        assert common.maybe_constrain(x, common.BATCH_AXES, None) is x
    finally:
        common.set_mesh_axes(())
    assert common.data_shards() == 1


def test_serving_fsdp_threshold_is_half_the_card():
    mesh = StandIn((32, 8), MESHES[(32, 8)])
    # qwen3-8b's bf16 weights over 8 model ranks fit without FSDP; arctic's
    # 480B do not
    assert not shapes.serving_fsdp(get_config("qwen3-8b"), mesh)
    assert shapes.serving_fsdp(get_config("arctic-480b"), mesh)
    assert shapes.SERVING_FSDP_BYTES == 40e9
