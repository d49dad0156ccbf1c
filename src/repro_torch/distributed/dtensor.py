"""DTensor helpers of the port's sharded paths: placements of a spec,
head split/merge on sharded fused dims, ``local_map`` regions over each
rank's rows and heads, per-layer FSDP gathers, and the functional
collectives used inside regions. Every helper passes a plain tensor
through as it is, so the single-device paths never see a mesh."""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

# mesh axes the batch shards over (the reference's ``common.BATCH_AXES``)
BATCH_AXES = ("pod", "data")


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def placements_for(spec, mesh_axes) -> list:
    """DTensor placements of a per-tensor-dim spec (entries None, an axis
    name or a tuple of names) over mesh axes ``mesh_axes`` (in the mesh's
    major-to-minor order): mesh axis a shards the tensor dim whose entry
    names it, else replicates. A dim over two mesh axes is ``Shard(d)`` on
    both, in mesh order, as a JAX ``PartitionSpec`` tuple entry is."""
    out = []
    for a in mesh_axes:
        dim = None
        for i, e in enumerate(spec):
            if e == a or (isinstance(e, tuple) and a in e):
                dim = i
        out.append(Shard(dim) if dim is not None else Replicate())
    return out


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd). A DTensor whose fused last dim is
    sharded over more ranks than ``n`` divides is first replicated along
    it (GSPMD pads there; DTensor cannot unflatten it)."""
    if is_dtensor(t):
        last, ranks = t.dim() - 1, 1
        for md, p in enumerate(t.placements):
            if p.is_shard(last):
                ranks *= t.device_mesh.size(md)
        if n % ranks:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard(last) else p
                for p in t.placements])
    return t.reshape(*t.shape[:-1], n, hd)


class _KeepLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward value
    was (DTensor may hand back a layout the op before cannot take)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) -> (..., n * hd). On a DTensor the gradient comes back
    in the merged value's own layout, so that the backward's split never
    meets a fused dim sharded over more ranks than ``n`` divides."""
    t = t.reshape(*t.shape[:-2], -1)
    return _KeepLayout.apply(t) if is_dtensor(t) else t


def blockwise(fn, x: torch.Tensor, dims=()) -> torch.Tensor:
    """``fn(x)`` for an op that DTensor has no rule for and that acts on
    each rank's block alone: elementwise, or along ``dims``, which are
    first made whole on every rank (as is a pending sum). The result keeps
    x's layout; differentiable, and ``fn(x)`` itself for a plain tensor."""
    if not is_dtensor(x):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() or any(p.is_shard(d) for d in dims)
          else p for p in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    return DTensor.from_local(fn(x.to_local()), mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def rows_heads(fn, args, layouts, out_layouts, heads=None):
    """``fn(*args)`` on DTensors as a ``local_map`` region over each rank's
    rows and heads. ``layouts[i]`` is (batch dim or None, head dim or None)
    of ``args[i]``; likewise ``out_layouts`` for the outputs. Rows shard
    over the batch axes when the batch divides them, and heads (experts,
    for a MoE) over ``model`` when every head count does (``heads``, if
    given, is the count), else they are whole on every rank. A replicated
    input that meets other ranks' rows or heads gets a pending-sum
    gradient. Non-tensor arguments pass as they are. Differentiable."""
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    names = mesh.mesh_dim_names
    tensor = [isinstance(a, torch.Tensor) for a in args]
    dims = [(a.shape[l[0]] if l[0] is not None else None,
             a.shape[l[1]] if l[1] is not None else None)
            for a, l, t in zip(args, layouts, tensor) if t]
    batch = math.prod(mesh.size(md) for md, a in enumerate(names)
                      if a in BATCH_AXES)
    B = next((b for b, _ in dims if b is not None), None)
    H = [heads] if heads is not None else [h for _, h in dims
                                           if h is not None]
    split_rows = B is not None and B % batch == 0
    split_heads = bool(H) and "model" in names and all(
        h % mesh.size(names.index("model")) == 0 for h in H)

    def place(layout, grad=False):
        b, h = layout
        out = []
        for a in names:
            if a in BATCH_AXES and split_rows:
                out.append(Shard(b) if b is not None else
                           Partial() if grad else Replicate())
            elif a == "model" and split_heads:
                out.append(Shard(h) if h is not None else
                           Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return out

    args = [replicated(a, mesh) if t else a for a, t in zip(args, tensor)]
    return local_map(
        fn, out_placements=tuple(place(l) for l in out_layouts),
        in_placements=tuple(place(l) if t else None
                            for l, t in zip(layouts, tensor)),
        in_grad_placements=tuple(place(l, grad=True) if t else None
                                 for l, t in zip(layouts, tensor)),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def replicate(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated over its whole mesh (a plain tensor as is)."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def gather_fsdp(p: dict, skip: str = "\0") -> dict:
    """A layer's weights with their FSDP shards (the d_model dim over the
    batch axes) gathered whole, the tensor-parallel ``model`` shards kept:
    ZeRO-3's gather before use. Inside a rematerialised layer it reruns in
    the backward pass, and its adjoint reduce-scatters the gradients. Names
    starting with ``skip`` keep their layout (a MoE lays out its experts
    itself). Plain tensors pass as they are."""
    out = {}
    for k, t in p.items():
        if is_dtensor(t) and not k.startswith(skip) and any(
                pl.is_shard() and a in BATCH_AXES for pl, a in zip(
                    t.placements, t.device_mesh.mesh_dim_names)):
            t = t.redistribute(t.device_mesh, [
                Replicate() if pl.is_shard() and a in BATCH_AXES else pl
                for pl, a in zip(t.placements, t.device_mesh.mesh_dim_names)])
        out[k] = t
    return out


def replicated(x: torch.Tensor, mesh):
    """A plain tensor that every rank holds the same as a replicated
    DTensor on ``mesh`` (no collective)."""
    if x is None or is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def all_gather_dim(x: torch.Tensor, dim: int, mesh, mesh_dim: int
                   ) -> torch.Tensor:
    """Inside a ``local_map`` region: the blocks of ``x`` along ``dim``
    from every rank of mesh dim ``mesh_dim``, concatenated in rank order
    (a functional all-gather)."""
    n = mesh.size(mesh_dim)
    if n == 1:
        return x
    ops = torch.ops._c10d_functional
    g = ops.all_gather_into_tensor(x.movedim(dim, 0).contiguous(), n,
                                   mesh.get_group(mesh_dim).group_name)
    return ops.wait_tensor(g).movedim(0, dim)


class _Psum(torch.autograd.Function):
    """The sum over a mesh dim's ranks; its gradient is the output's on
    every rank (each rank's input reaches the replicated sum once)."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim):
        return all_reduce_sum(x, mesh, mesh_dim)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """Inside a ``local_map`` region: the reference's ``lax.psum``, a
    differentiable functional all-reduce over mesh dim ``mesh_dim``."""
    return _Psum.apply(x, mesh, mesh_dim)


def all_reduce_sum(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """Inside a ``local_map`` region: the sum of ``x`` over the ranks of
    mesh dim ``mesh_dim`` (a functional all-reduce)."""
    return _all_reduce(x, "sum", mesh, mesh_dim)


def all_reduce_max(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """Inside a ``local_map`` region: the elementwise max of ``x`` over the
    ranks of mesh dim ``mesh_dim`` (not differentiable)."""
    return _all_reduce(x, "max", mesh, mesh_dim)


def _all_reduce(x: torch.Tensor, op: str, mesh, mesh_dim: int
                ) -> torch.Tensor:
    if mesh.size(mesh_dim) == 1:
        return x
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(
        x.contiguous(), op, mesh.get_group(mesh_dim).group_name))
