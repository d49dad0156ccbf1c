"""Top-k MoE with capacity-based scatter dispatch, in PyTorch: the port of
``repro.models.moe.moe_apply``: its single-device ``D = 1`` path, and its
row-blocked ``D > 1`` and expert-parallel paths under a mesh, as one
row-blocked dispatch (a single device runs one row).

Dispatch is sort-free, as the reference's: each (token, slot) assignment's
position within its expert comes from a one-hot cumsum over the call's
flattened assignments (token-major), assignments at or past the expert's
capacity are dropped, and the kept tokens are scattered into a (D, E, C, d)
buffer that every expert runs as one batched SwiGLU. The capacity depends
on the call's token count (``capacity``), so a MoE call's output depends on
its shape and on where pad tokens sit: the engine runs MoE stacks at the
reference's padded shapes.

Where the reference scatters with ``mode="drop"`` and gathers with
``mode="fill"``, the buffer here has one more column: dropped assignments
land in column C, which is cut off before the experts run and is zero when
the outputs are gathered back. The expert contraction is a plain batched
product, as in the reference (no Pallas kernel there).

Row-blocked dispatch (``D = common.data_shards()`` > 1, the reference's
GShard-style per-shard capacity): the T tokens are cut into D rows of
T / D, each expert has ``capacity(cfg, T / D)`` slots per row, and
positions come from a within-row cumsum, so no token crosses a data
shard. Under a ``DeviceMesh`` (tensors are DTensors) routing, dispatch and
combine are ``local_map`` regions over each rank's rows: each ``model``
rank scatters into its E / model experts (an assignment to another rank's
expert drops locally), and the combine's ``psum`` over ``model`` is a
functional all-reduce. A decode-sized call (``D = 1``, data and model
axes above 1, with or without a pod axis) contracts the d-sharded expert
weights in place and all-reduces MB-sized partials over ``data`` instead
of gathering the weights (``_expert_ffn_decode``).

Under a batch that the batch axes do not divide, the model pads each
rank's rows to ceil(B / n) (``dtensor.pad_rows``) and passes the real B
down (``rows``): the dispatch then makes the reference's decisions on the
real tokens alone. D comes from the real T = B S, the rows are the real
tokens in flattened order cut into D parts of T / D, each with
``capacity(cfg, T / D)`` slots an expert, and pad tokens take no slot and
add nothing to the aux loss. No token moves: a rank's real tokens are a
contiguous run of that order, so an assignment's position in its
reference row is its position among the rank's own assignments to the
same row and expert plus the count of those on earlier batch ranks, an
exclusive scan of a (rows touched, E) count that one small all-gather
over the batch ranks gives (``_route_padded``). Each rank scatters its
kept assignments into a buffer of the reference rows it touches and
combines locally, as when the batch divides.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.dtensor import (all_gather_dim, all_reduce_sum,
                                   gather_rows, is_dtensor, psum, rows_heads)
from .common import (BATCH_AXES, EMBED, EXPERT, MLP, NUL, ParamMeta, ParamTree,
                     active_mesh, data_shards, maybe_constrain)
from .config import ModelConfig


def moe_params(cfg: ModelConfig) -> ParamTree:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    return {
        "router": ParamMeta((d, e), (EMBED, NUL), init="small"),
        "w_gate": ParamMeta((e, d, f), (EXPERT, EMBED, MLP)),
        "w_up": ParamMeta((e, d, f), (EXPERT, EMBED, MLP)),
        "w_down": ParamMeta((e, f, d), (EXPERT, MLP, EMBED)),
    }


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.experts_per_token * num_tokens
            / max(1, cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first on ties (``torch.topk`` promises no order among equals)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# --------------------------------------------------------------------------- #
# row-blocked dispatch and the expert-parallel regions under a mesh
# --------------------------------------------------------------------------- #
def _route(xf: torch.Tensor, router: torch.Tensor, k: int, E: int, Cl: int):
    """Routing of (D,Tl,d) rows, each row on its own: (gate (D,Tl,k),
    e_flat (D,Tl*k), pos_s (D,Tl*k) with dropped assignments at Cl, keep,
    per-row shares of the assignments (D,E) and mean probs (D,E))."""
    D, Tl, _ = xf.shape
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)  # (D,Tl,E)
    gate, idx = top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(D, Tl * k)
    onehot = F.one_hot(e_flat, E)                               # (D,Tl*k,E)
    pos = (onehot.cumsum(1) - 1).gather(2, e_flat[..., None])[..., 0]
    keep = pos < Cl
    pos_s = torch.where(keep, pos, torch.full_like(pos, Cl))
    return gate, e_flat, pos_s, keep, onehot.float().mean(1), probs.mean(1)


def _local(e_flat, pos_s, E_loc: int, e0, Cl: int):
    """Each assignment's (expert, slot) in a buffer of experts
    [e0, e0 + E_loc); one to another rank's expert goes to slot Cl (cut
    off). ``e0`` None: every expert is local."""
    if e0 is None:
        return e_flat, pos_s
    e_loc = e_flat - e0
    ok = (e_loc >= 0) & (e_loc < E_loc)
    return (torch.where(ok, e_loc, torch.zeros_like(e_loc)),
            torch.where(ok, pos_s, torch.full_like(pos_s, Cl)))


def _rows_of(e_flat, row):
    """Each assignment's buffer row: ``row`` (``_route_padded``), or the
    row of ``e_flat`` it sits in."""
    if row is not None:
        return row
    D = e_flat.shape[0]
    return torch.arange(D, device=e_flat.device)[:, None].expand_as(e_flat)


def _dispatch(xf, e_flat, pos_s, k: int, E_loc: int, e0, Cl: int,
              row=None, R=None):
    """Scatter the (D,Tl*k) token copies of rows xf (D,Tl,d) into experts
    [e0, e0 + E_loc) (``_local``): a (D,E_loc,Cl,d) buffer, or one of R
    rows where ``row`` gives each assignment's. Assignments to other
    experts or past the capacity land in a column Cl that is cut off."""
    D, Tl, d = xf.shape
    e_w, pos_w = _local(e_flat, pos_s, E_loc, e0, Cl)
    r = _rows_of(e_flat, row)
    t_flat = torch.arange(Tl * k, device=xf.device) // k
    buf = xf.new_zeros((D if R is None else R, E_loc, Cl + 1, d))
    buf[r, e_w, pos_w] = xf[:, t_flat]
    return buf[:, :, :Cl]


def _combine(out_buf, e_flat, pos_s, e0, row=None):
    """Each (row, assignment)'s expert output from out_buf (D,E_loc,Cl,d)
    holding experts [e0, e0 + E_loc), the buffer row ``row`` where given;
    zero for a drop or another expert."""
    D, E_loc, Cl, d = out_buf.shape
    e_w, pos_w = _local(e_flat, pos_s, E_loc, e0, Cl)
    out = torch.cat([out_buf, out_buf.new_zeros((D, E_loc, 1, d))], dim=2)
    return out[_rows_of(e_flat, row), e_w, pos_w]              # (D,Tl*k,d)


def _swiglu_experts(p, buf):
    """SwiGLU of every expert over its rows: buf (D,E,Cl,d) -> (D,E,Cl,d)."""
    g = torch.einsum("recd,edf->recf", buf, p["w_gate"])
    u = torch.einsum("recd,edf->recf", buf, p["w_up"])
    return torch.einsum("recf,efd->recd", F.silu(g) * u, p["w_down"])


def _expert_ffn_decode(p, buf, mesh):
    """The decode schedule (D = 1; data and model above 1): each (data,
    model) rank contracts its d block of its experts' weights, the
    partials all-reduce over ``data`` (MB-sized) and the d blocks of the
    output gather over ``data``; GSPMD's default would gather the weights
    (GBs a layer for the 480B MoE). A ``pod`` axis is pure data
    parallelism: the weights and the call's tokens are the same in every
    pod, so each pod runs the single-pod schedule on its own ranks, and
    no collective crosses pods."""
    names = mesh.mesh_dim_names
    di = names.index("data")

    def pl(**dims):
        return [Shard(dims[a]) if a in dims else Replicate() for a in names]

    def local(buf_l, wg_l, wu_l, wd_l):
        i, dl = mesh.get_coordinate()[di], wg_l.shape[1]
        bslice = buf_l[0][..., i * dl:(i + 1) * dl]
        g = all_reduce_sum(torch.einsum("ecd,edf->ecf", bslice, wg_l),
                           mesh, di)
        u = all_reduce_sum(torch.einsum("ecd,edf->ecf", bslice, wu_l),
                           mesh, di)
        y_l = torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd_l)
        return all_gather_dim(y_l, 2, mesh, di)[None]

    return local_map(
        local, out_placements=pl(model=1),
        in_placements=(pl(model=1), pl(model=0, data=1), pl(model=0, data=1),
                       pl(model=0, data=2)),
        device_mesh=mesh, redistribute_inputs=True)(
            buf, p["w_gate"], p["w_up"], p["w_down"])


def _batch_rank(mesh) -> Tuple[int, int, list]:
    """(this rank's index over the mesh's batch axes in row-major order, as
    nested even shards order their chunks; those axes' rank count; their
    mesh dims)."""
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    dims = [md for md, a in enumerate(names) if a in BATCH_AXES]
    i, n = 0, 1
    for md in dims:
        i, n = i * mesh.size(md) + coord[md], n * mesh.size(md)
    return i, n, dims


def _padded_rows(n: int, blk: int, T: int, Tl: int) -> int:
    """The most reference rows of Tl tokens that one batch rank's block of
    ``blk`` padded tokens touches, when the T real tokens come first."""
    return max((min((j + 1) * blk, T) - 1) // Tl - j * blk // Tl + 1
               for j in range(n) if j * blk < T)


def _route_padded(xf, router, k: int, E: int, Cl: int, mesh, T: int,
                  Tl: int, R: int):
    """``_route`` of this batch rank's block xf (1,blk,d) of a padded call
    (inside a region), with the reference's decisions: the real tokens
    (global index below T; a rank's come first in its block) in rows of Tl
    by global index, positions within each (row, expert) counted over the
    real assignments of every batch rank (an all-gather of each rank's
    (R, E) counts), pads kept out of every slot and of the aux. Returns
    ``_route``'s outputs, the shares scaled so that their mean over the
    ranks is the reference's, and each assignment's buffer row (1,blk*k)
    among the R reference rows from the block's first."""
    _, blk, _ = xf.shape
    i, n, dims = _batch_rank(mesh)
    dev = xf.device
    g = i * blk + torch.arange(blk, device=dev)            # global token
    real = (g < T)[None]                                   # (1,blk)
    lo = i * blk // Tl                                     # first row
    row = (g // Tl - lo).clamp(0, R - 1).repeat_interleave(k)[None]
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)  # (1,blk,E)
    gate, idx = top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(1, blk * k)
    key = row * E + e_flat                                 # (row, expert)
    ok = real.repeat_interleave(k, dim=1)
    onehot = F.one_hot(key, R * E) * ok[..., None]         # (1,blk*k,R*E)
    cnt = onehot.sum(1)                                    # (1,R*E)
    counts = cnt
    for md in reversed(dims):                              # minor axis first
        counts = all_gather_dim(counts, 0, mesh, md)       # (n,R*E) at last
    # the same rows' counts on the ranks before this one: rank j's row r
    # is reference row lo_j + r
    lo_j = torch.arange(i, device=dev) * blk // Tl
    off = lo + torch.arange(R, device=dev)[None] - lo_j[:, None]   # (i,R)
    hit = (off >= 0) & (off < R)
    prev = counts[:i].reshape(i, R, E).gather(
        1, off.clamp(0, R - 1)[..., None].expand(i, R, E))
    before = (prev * hit[..., None]).sum(0).reshape(1, R * E)
    pos = (onehot.cumsum(1) - 1).gather(2, key[..., None])[..., 0] \
        + before.gather(1, key)
    keep = ok & (pos < Cl)
    pos_s = torch.where(keep, pos, torch.full_like(pos, Cl))
    tok_share = cnt.reshape(R, E).sum(0)[None].float() * (n / (T * k))
    prob_mean = (probs * real[..., None]).sum(1) * (n / T)
    return gate, e_flat, pos_s, keep, tok_share, prob_mean, row


def _moe_rows(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
              D: int, real=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """D rows of T / D tokens, each with its own expert capacity (one row
    of all T tokens on a single device); under a mesh, ``local_map``
    regions per rank. ``real``: x is a padded batch (``dtensor.pad_rows``)
    of that many real rows, and the rows are the reference's over those
    (``_route_padded``)."""
    B, S, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    T = B * S if real is None else real * S
    Tl = T // D
    Cl = capacity(cfg, Tl)
    mesh = active_mesh() if is_dtensor(x) else None
    if real is None:
        nb, Tb = D, Tl                  # blocks of x that hold the rows
    else:
        nb = _batch_rank(mesh)[1]       # one block a batch rank
        Tb = B * S // nb
        R = _padded_rows(nb, Tb, T, Tl)
    xf = x.reshape(nb, Tb, d)
    if mesh is None:
        gate, e_flat, pos_s, keep, tok_share, prob_mean = _route(
            xf, p["router"], k, E, Cl)
        buf = _dispatch(xf, e_flat, pos_s, k, E, None, Cl)
        out_buf = _swiglu_experts(p, buf)
        yv = _combine(out_buf, e_flat, pos_s, None)
    else:
        if D > 1 or real is not None:
            xf = maybe_constrain(xf, BATCH_AXES, None, None)
        else:
            # the tokens of one row, whole on every rank: one gather over
            # pod and data together (the regions below would gather them
            # axis by axis, twice)
            xf = gather_rows(xf, 1)
        names = mesh.mesh_dim_names
        model_n = mesh.size(names.index("model"))
        ep = E % model_n == 0           # each model rank holds E / model_n
        E_loc = E // model_n if ep else E

        def e0():
            return mesh.get_coordinate()[names.index("model")] * E_loc \
                if ep else None

        # regions over each rank's rows (and experts); the gradient of an
        # input they replicate sums over the ranks whose blocks differ: the
        # router's over the rows, the tokens' over the model ranks that
        # each scatter to their own experts (``dtensor.rows_heads``)
        rows, ebuf, full, experts = (0, None), (0, 1), (None, None), \
            (None, 0)
        if real is None:
            row, R = None, None
            gate, e_flat, pos_s, keep, tok_share, prob_mean = rows_heads(
                lambda a, r: _route(a, r, k, E, Cl), (xf, p["router"]),
                (rows, full), (rows,) * 6)
        else:
            gate, e_flat, pos_s, keep, tok_share, prob_mean, row = \
                rows_heads(lambda a, r: _route_padded(
                    a, r, k, E, Cl, mesh, T, Tl, R), (xf, p["router"]),
                    (rows, full), (rows,) * 7)
        buf = rows_heads(
            lambda a, e, s, r: _dispatch(a, e, s, k, E_loc, e0(), Cl, r, R),
            (xf, e_flat, pos_s, row), (rows,) * 4, (ebuf,), heads=E)
        # one row (D = 1): laid out within each pod, as on a single pod (a
        # pod holds the same tokens and weights), so that no gather of it
        # crosses pods
        one_row = D == 1 and real is None
        row_axes = "data" if one_row else BATCH_AXES
        buf = maybe_constrain(buf, row_axes, "model", None, None)
        data_n = mesh.size(names.index("data")) if "data" in names else 1
        f = p["w_gate"].shape[-1]
        if one_row and ep and model_n > 1 and data_n > 1 \
                and d % data_n == 0 and f % data_n == 0:
            out_buf = _expert_ffn_decode(p, buf, mesh)
        else:
            # each rank's rows through its experts' whole weights
            out_buf = rows_heads(
                lambda b, g, u, w: _swiglu_experts(
                    {"w_gate": g, "w_up": u, "w_down": w}, b),
                (buf, p["w_gate"], p["w_up"], p["w_down"]),
                (ebuf,) + (experts,) * 3, (ebuf,), heads=E)
        out_buf = maybe_constrain(out_buf, row_axes, "model", None, None)

        def combine(b, e, s, r):
            yv = _combine(b, e, s, e0(), r)
            # other model ranks contribute their experts' tokens
            return psum(yv, mesh, names.index("model")) if ep else yv

        yv = rows_heads(combine, (out_buf, e_flat, pos_s, row),
                        (ebuf, rows, rows, rows), (rows,), heads=E)
    w = (gate.reshape(nb, Tb * k) * keep).to(x.dtype)
    y = (yv * w[..., None]).reshape(nb, Tb, k, d).sum(dim=2).reshape(B, S, d)

    # Switch-style load-balance aux loss over all D rows (of equal size)
    frac_tokens = tok_share.mean(0) * k
    frac_probs = prob_mean.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux


def moe_apply(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
              rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux load-balance loss, a float32 scalar).

    D = ``data_shards()`` rows; a decode-sized call (T < 16 D, or T not a
    multiple of D) keeps one row, so its tokens stay replicated over the
    data axis (the reference's rule, ``moe.py:166-175``). ``rows``: the
    real batch of a call whose x the model padded to more rows
    (``dtensor.pad_rows``); T counts its tokens only."""
    B, S, _ = x.shape
    real = rows if rows is not None and rows < B else None
    T = (B if real is None else real) * S
    D = data_shards()
    if T % D != 0 or T < 16 * D:
        D = 1
    return _moe_rows(p, cfg, x, D, real)
