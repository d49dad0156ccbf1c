"""AdamW with a configurable state dtype, line for line with
``repro.training.optimizer``: a global-norm clip in float32, linear warmup
(taken from the incremented step, as the reference), bias corrections as
float32 powers, weight decay added to the update (not decoupled), moments
stored in ``state_dtype`` and params cast back to their own dtype.

``apply_updates`` writes the new params and moments into the given tensors
(the reference returns new arrays from donated buffers): at qwen3-8b's
widths a second copy of the float32 moments would not fit beside the
first. It works through large leaves a block of rows at a time, which
changes no number (every operation but the norm is elementwise).

On DTensor params (a mesh) the moments share each param's placements,
each gradient is laid out as its param, and the updates run in place on
every rank's local block (``to_local()``). The global norm sums each
rank's local squares once per block: a rank adds a param's squares only
where it is the first replica along every mesh dim that replicates the
param, and one functional all-reduce a mesh dim sums the rest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..distributed.dtensor import all_reduce_sum, is_dtensor
from ..models.model import dtype_of

Params = Dict[str, torch.Tensor]

BLOCK = 1 << 26             # elements a leaf is updated in at a time


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


def init_state(params: Params, cfg: AdamWConfig) -> Dict:
    dt = dtype_of(cfg.state_dtype)
    z = lambda p: torch.zeros_like(p, dtype=dt)     # a DTensor keeps its layout
    dev = next(iter(params.values())).device
    return {"m": {k: z(p) for k, p in params.items()},
            "v": {k: z(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def _sharded_sq_norm(params: Params, grads: Params) -> torch.Tensor:
    """The squared global norm of DTensor ``grads`` laid out as ``params``
    (each block counted once), on every rank."""
    mesh = next(iter(params.values())).device_mesh
    coord = mesh.get_coordinate()
    sq = torch.zeros((), dtype=torch.float32,
                     device=next(iter(grads.values())).to_local().device)
    for k, g in grads.items():
        if all(coord[md] == 0 for md, pl in enumerate(params[k].placements)
               if not pl.is_shard()):
            sq = sq + torch.sum(torch.square(g.to_local().float()))
    for md in range(mesh.ndim):
        sq = all_reduce_sum(sq, mesh, md)
    return sq


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict,
                  cfg: AdamWConfig) -> Tuple[Params, Dict, torch.Tensor]:
    """Returns (params, state, grad_norm); ``params`` and the moments of
    ``state`` are updated in place, ``step`` is a new tensor."""
    step = state["step"] + 1
    if any(is_dtensor(p) for p in params.values()):
        grads = {k: g.redistribute(params[k].device_mesh, params[k].placements)
                 for k, g in grads.items()}
        sq = _sharded_sq_norm(params, grads)
    else:
        sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip \
        else torch.ones((), device=gnorm.device)
    lr = _schedule(cfg, step)
    stepf = step.float()
    c1 = 1 - cfg.b1 ** stepf
    c2 = 1 - cfg.b2 ** stepf
    dt = dtype_of(cfg.state_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * torch.square(g)
        mh = m32 / c1
        vh = v32 / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m32.to(dt))
        v.copy_(v32.to(dt))

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    for k, p in params.items():
        leaves = tuple(local(a) for a in (p, grads[k], state["m"][k],
                                          state["v"][k]))
        p = leaves[0]
        rows = max(1, BLOCK // max(1, p[0].numel())) if p.dim() else 1
        if p.dim() == 0 or p.shape[0] <= rows:
            upd(*leaves)
            continue
        for i in range(0, p.shape[0], rows):
            upd(*(a[i:i + rows] for a in leaves))
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
