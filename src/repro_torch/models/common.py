"""Shared building blocks: parameter metadata and init, norms, rotary
embeddings, softcap and SwiGLU, in PyTorch.

Parameters live in a flat dict ``{name: tensor}``; every module contributes
``ParamMeta`` (shape, logical axes, init rule, scale) and ``init_params``
materialises them with the reference's std rule (``scale / sqrt(fan_in)``,
ones for norms) from an explicit ``torch.Generator``; ``abstract_params``
gives the same tree as tensors on the ``meta`` device, and the logical axes
map onto a mesh in ``distributed/sharding.py``. ``cross_entropy`` is the
training loss. The numbers differ from JAX's threefry draws; the tests
carry the reference's weights across instead (``weights.params_from_jax``).

The mesh hooks (``set_mesh_axes``, ``active_mesh``, ``data_shards``,
``maybe_constrain``) are the reference's: the launchers declare the mesh,
and with none declared every hook is a no-op.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..distributed.dtensor import (BATCH_AXES, all_reduce_max, is_dtensor,
                                   pad_rows, padded_rows, placements_for,
                                   psum, rows_heads, unpad_rows)


# Logical axis names. distributed/sharding.py maps these to mesh axes.
VOCAB = "vocab"
EMBED = "embed"        # d_model
HEADS = "heads"        # fused q heads * head_dim
KV = "kv"              # fused kv heads * head_dim
MLP = "mlp"            # ffn hidden
EXPERT = "expert"
INNER = "inner"        # ssm/xlstm inner width
STATE = "state"        # ssm state dim
LAYER = "layer"        # stacked-layer leading dim
NUL = None


@dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


ParamTree = Dict[str, ParamMeta]


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # last dim is fan-out by convention; everything before contracts
    return int(math.prod(shape[:-1]))


def materialize(meta: ParamMeta, gen: torch.Generator, dtype: torch.dtype,
                device) -> torch.Tensor:
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dtype, device=device)
    std = meta.scale / math.sqrt(max(1, _fan_in(meta.shape)))
    if meta.init == "small":
        std *= 0.1
    out = torch.empty(meta.shape, dtype=dtype, device=device)
    # draw in float32 one leading slice at a time (a stacked (L, ...) weight
    # never needs a float32 copy of the whole stack)
    flat = out.view(-1, *meta.shape[-2:]) if len(meta.shape) > 2 else \
        out.view(1, *meta.shape)
    for i in range(flat.shape[0]):
        x = torch.randn(flat.shape[1:], generator=gen, dtype=torch.float32,
                        device=device)
        flat[i].copy_(x.mul_(std))
    return out


def init_params(tree: ParamTree, gen: torch.Generator, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    return {n: materialize(tree[n], gen, dtype, device) for n in sorted(tree)}


def abstract_params(tree: ParamTree, dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """The tree as tensors on the ``meta`` device: shapes and dtype, no
    storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return {n: torch.empty(m.shape, dtype=dtype, device="meta")
            for n, m in tree.items()}


def param_axes(tree: ParamTree) -> Dict[str, Tuple[Optional[str], ...]]:
    return {n: m.axes for n, m in tree.items()}


# --------------------------------------------------------------------------- #
# numerics (float32 inside, as the reference)
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., S, hd/2)
    angles = angles[..., :, None, :]                      # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE, the reference's: logits (..., V), labels (...)
    int. The log-sum-exp runs in float32; the label's logit is gathered
    (the same number as the reference's one-hot contraction, without a
    (N, V) one-hot). On a DTensor it is vocab-parallel (``_ce_sharded``)."""
    if is_dtensor(logits):
        # a sum over the ranks' rows (some may hold none: an uneven batch)
        # over the token count
        ce = _ce_sharded(logits, labels)
        return ce.sum() / ce.numel()
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0].float()
    return (lse - ll).mean()


def _ce_sharded(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE of DTensor logits (..., V), Megatron's vocab-parallel
    CE: in a region over each rank's rows and block of the vocab, the max
    and the sum of exponentials reduce over "model" and the label's logit
    comes from the rank that holds it, so no rank builds a (N, V) tensor
    wider than its own block."""
    B = logits.shape[0]
    if padded_rows(logits) != B:
        # a batch the batch axes do not divide: each rank's rows padded
        # (the labels come sharded as the logits), the pad rows' CE dropped
        return unpad_rows(_ce_sharded(pad_rows(logits), pad_rows(labels)),
                          B)
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    split = mi is not None and logits.shape[-1] % mesh.size(mi) == 0

    def local(lg, lab):
        lg = lg.float()
        cols = lg.shape[-1]
        m = lg.detach().amax(-1)
        idx = lab.long()
        if split:
            m = all_reduce_max(m, mesh, mi)
            idx = idx - mesh.get_coordinate()[mi] * cols
        mine = (idx >= 0) & (idx < cols)
        se = (lg - m[..., None]).exp().sum(-1)
        ll = lg.gather(-1, idx.clamp(0, cols - 1)[..., None])[..., 0] * mine
        if split:
            se, ll = psum(se, mesh, mi), psum(ll, mesh, mi)
        return m + torch.log(se) - ll

    return rows_heads(local, (logits, labels),
                      ((0, logits.dim() - 1), (0, None)), ((0, None),),
                      heads=logits.shape[-1])


# --------------------------------------------------------------------------- #
# mesh hooks
# --------------------------------------------------------------------------- #
_ACTIVE_MESH_AXES: tuple = ()
_ACTIVE_MESH_SIZES: dict = {}
_ACTIVE_MESH = None


def set_mesh_axes(axes, sizes: dict | None = None, mesh=None) -> None:
    """Declare the mesh axis names (and sizes) activation constraints may
    reference, and the ``DeviceMesh`` they live on. Called by the launchers
    (``build_step`` / train); empty in the single-device paths, where
    ``maybe_constrain`` is a no-op and ``data_shards`` is 1."""
    global _ACTIVE_MESH_AXES, _ACTIVE_MESH_SIZES, _ACTIVE_MESH
    _ACTIVE_MESH_AXES = tuple(axes)
    _ACTIVE_MESH_SIZES = dict(sizes or {})
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


def data_shards() -> int:
    """Product of the batch-axis sizes of the active mesh (1 in tests)."""
    n = 1
    for a in BATCH_AXES:
        n *= _ACTIVE_MESH_SIZES.get(a, 1)
    return n


def maybe_constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against the declared
    mesh axes: a no-op when none are declared, or when ``x`` is not a
    DTensor; else ``x`` is redistributed to the named placements (a mesh
    axis no entry names replicates). Entries may be None / str / tuple;
    names not on the mesh are dropped."""
    names = set(_ACTIVE_MESH_AXES)
    if not names or _ACTIVE_MESH is None:
        return x
    if not isinstance(x, DTensor):
        return x

    def ok(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            picked = tuple(x_ for x_ in a if x_ in names)
            return picked or None
        return a if a in names else None

    spec = [ok(a) for a in axes]
    want = tuple(placements_for(spec, x.device_mesh.mesh_dim_names))
    if want == tuple(x.placements):
        return x
    if any(p.is_partial() and w.is_shard()
           for p, w in zip(x.placements, want)):
        return _ReduceScatter.apply(x, want)
    return x.redistribute(x.device_mesh, want)


class _ReduceScatter(torch.autograd.Function):
    """A pending sum moved straight to a shard (a reduce-scatter), whose
    backward gathers the gradient whole: DTensor's own backward asks for a
    shard-to-sum move that older releases refuse."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.back = [Replicate() if p.is_partial() else p
                    for p in x.placements]
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


