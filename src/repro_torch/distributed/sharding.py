"""Logical-axis -> mesh-axis sharding rules (MaxText-style), the
reference's ``repro.distributed.sharding`` over a ``DeviceMesh``.

Parameters carry logical axis names (``repro_torch.models.common``); this
module maps them to per-tensor-dim specs for a given mesh:

  * exactly one "model"-class logical axis per tensor is sharded over the
    mesh "model" axis (priority: experts > vocab > heads/kv > mlp > inner);
  * the d_model ("embed") axis is FSDP-sharded over "data" within a pod;
  * the "pod" axis (multi-pod mesh) is pure data parallelism: parameters
    replicated across pods, batch sharded over ("pod", "data").

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dim: None, a mesh-axis name, or a tuple of names.
``dtensor.placements_for`` turns it into DTensor placements (``Shard(d)``
on every mesh dim that names d, ``Replicate()`` elsewhere).

Size-aware rules demote a dim that does not divide its mesh axis to
replicated, as the reference's explicit input shardings must. Head counts
that do not divide the model axis (56 heads, kv=8 on a 16-way axis) stay
legal in activations: DTensor shards them unevenly where GSPMD pads.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or anything with
``axis_names`` and ``devices.shape`` (all the rules read).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.dtensor import placements_for
from repro_torch.models import common as C
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

# logical axes that map to the tensor-parallel "model" mesh axis, in
# priority order (first match wins per tensor)
MODEL_CLASS = (C.EXPERT, C.VOCAB, C.HEADS, C.KV, C.MLP, C.INNER)

Spec = Tuple


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        shape = tuple(mesh.shape)
    else:
        shape = tuple(mesh.devices.shape)
    return dict(zip(axis_names(mesh), shape))


def spec_for_axes(axes: Tuple[Optional[str], ...], *,
                  fsdp: bool = True) -> Spec:
    out = []
    model_used = False
    data_used = False
    # find the highest-priority model-class axis present
    present = [a for a in axes if a in MODEL_CLASS]
    chosen = None
    for cls in MODEL_CLASS:
        if cls in present:
            chosen = cls
            break
    for a in axes:
        if a == chosen and not model_used:
            out.append("model")
            model_used = True
        elif a == C.EMBED and fsdp and not data_used:
            out.append("data")
            data_used = True
        else:
            out.append(None)
    return tuple(out)


def param_specs(cfg: ModelConfig, mesh=None, *,
                fsdp: bool = True) -> Dict[str, Spec]:
    """Size-aware: any sharded dim that does not divide its mesh axis is
    demoted to replicated (explicit input shardings must divide evenly)."""
    tree = model_lib.param_tree(cfg)
    out = {}
    axis_size = axis_sizes(mesh) if mesh is not None else {}
    for k, m in tree.items():
        spec = list(spec_for_axes(m.axes, fsdp=fsdp))
        if mesh is not None:
            for i, a in enumerate(spec):
                if a is not None and m.shape[i] % axis_size[a] != 0:
                    spec[i] = None
        out[k] = tuple(spec)
    return out


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel submesh axes for the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``."""
    return placements_for(spec, axis_names(mesh))


def _local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shard shape of the mesh's rank 0 (every rank's, when each
    sharded dim divides; DTensor's chunks are ceil(n / k) long)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out[i] = -(-out[i] // sizes[a])
    return tuple(out)


def abstract_dtensor(shape, dtype: torch.dtype, spec: Spec, mesh,
                     device="meta"):
    """A DTensor of global ``shape`` whose local shard is an empty tensor on
    ``device`` (``meta`` for shapes only; fake tensors under
    ``FakeTensorMode``)."""
    local = torch.empty(_local_shape(shape, spec, mesh), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def shard_tensor(full: torch.Tensor, spec: Spec, mesh):
    """``full`` (the same on every rank) as a DTensor: this rank keeps its
    block of each sharded dim (in mesh order, major to minor), with no
    collective. Every sharded dim must divide its mesh axes, as the rules
    above guarantee. On a 1x1 mesh the DTensor wraps ``full`` itself."""
    pl = placements(spec, mesh)
    coord = mesh.get_coordinate()
    local = full
    for md, p in enumerate(pl):
        if p.is_shard():
            n, size = mesh.size(md), local.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not divide mesh dim {md} ({n})")
            local = local.narrow(p.dim, coord[md] * (size // n), size // n)
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_params_abstract(cfg: ModelConfig, mesh, *, fsdp: bool = True,
                          device="meta") -> Dict[str, torch.Tensor]:
    """Abstract params as DTensors with placements attached."""
    tree = model_lib.param_tree(cfg)
    dt = model_lib.dtype_of(cfg.param_dtype)
    specs = param_specs(cfg, mesh, fsdp=fsdp)
    return {k: abstract_dtensor(m.shape, dt, specs[k], mesh, device)
            for k, m in tree.items()}


def shard_params(params: Dict[str, torch.Tensor], cfg: ModelConfig, mesh,
                 *, fsdp: bool = True) -> Dict[str, torch.Tensor]:
    """Full parameters (the same on every rank) as DTensors under
    ``param_specs``."""
    specs = param_specs(cfg, mesh, fsdp=fsdp)
    return {k: shard_tensor(t, specs[k], mesh) for k, t in params.items()}


def cache_specs(cfg: ModelConfig, mesh, *, batch: int, capacity: int,
                shard_batch: bool, shard_seq: bool) -> dict:
    """Spec tree matching ``model.init_cache``'s structure, under the
    reference's cache names (``A``, ``M``, ``X``, ``S``, ``shared``; the
    port's ``init_cache`` keys its kinds the same way).

    shard_batch: batch dim over ("pod","data") (decode_32k);
    shard_seq: context dim over "data" instead (long_500k, batch=1).
    Explicit input shardings must divide evenly, so every rule falls back
    (kv-heads -> head_dim -> replicated) based on the actual dim sizes.
    """
    axis_size = axis_sizes(mesh)
    ba = batch_axes(mesh)
    ba_size = 1
    for a in ba:
        ba_size *= axis_size[a]

    b = ba if (shard_batch and batch % ba_size == 0) else None
    if b is not None and len(b) == 1:
        b = b[0]                # as a PartitionSpec entry normalises it
    model_n = axis_size["model"]
    data_n = axis_size["data"]

    def kv_spec(n_kv: int, hd: int, C: int) -> Spec:
        s = "data" if (shard_seq and C % data_n == 0) else None
        if n_kv % model_n == 0:
            return (None, b, s, "model", None)
        # GQA kv < model axis: shard the *sequence* dim over "model"
        # (flash-decode/context-parallel style)
        if s is None and C % model_n == 0:
            return (None, b, "model", None, None)
        if hd % model_n == 0:
            return (None, b, s, None, "model")
        return (None, b, s, None, None)

    kinds = model_lib.kind_counts(cfg)
    hd = cfg.resolved_head_dim
    specs: dict = {}
    if "A" in kinds:
        C = min(capacity, cfg.sliding_window) if cfg.sliding_window \
            else capacity
        kv = kv_spec(cfg.num_kv_heads, hd, C)
        specs["A"] = {"k": kv, "v": kv}
    if "M" in kinds:
        nh = cfg.ssm_heads
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        specs["M"] = {
            "h": (None, b, "model" if nh % model_n == 0 else None,
                  None, None),
            "conv": (None, b, None,
                     "model" if conv_dim % model_n == 0 else None)}
    if "X" in kinds:
        di = int(cfg.xlstm_proj_factor * cfg.d_model)
        nh = cfg.num_heads
        xhd = di // nh
        h_ax = "model" if nh % model_n == 0 else None
        d_ax = "model" if (h_ax is None and xhd % model_n == 0) else None
        specs["X"] = {"C": (None, b, h_ax, d_ax, None),
                      "n": (None, b, h_ax, d_ax),
                      "m": (None, b, h_ax)}
    if "S" in kinds:
        di = int(cfg.xlstm_proj_factor * cfg.d_model)
        sl = (None, b, "model" if di % model_n == 0 else None)
        specs["S"] = {"c": sl, "n": sl, "h": sl, "m": sl}
    if model_lib.num_shared_invocations(cfg):
        kvh = cfg.shared_attn_kv_heads or cfg.num_kv_heads
        kv = kv_spec(kvh, hd, capacity)
        specs["shared"] = {"k": kv, "v": kv}
    return specs
