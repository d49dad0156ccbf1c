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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

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
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = next(iter(params.values())).device
    return {"m": {k: z(p) for k, p in params.items()},
            "v": {k: z(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict,
                  cfg: AdamWConfig) -> Tuple[Params, Dict, torch.Tensor]:
    """Returns (params, state, grad_norm); ``params`` and the moments of
    ``state`` are updated in place, ``step`` is a new tensor."""
    step = state["step"] + 1
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

    for k, p in params.items():
        leaves = (p, grads[k], state["m"][k], state["v"][k])
        rows = max(1, BLOCK // max(1, p[0].numel())) if p.dim() else 1
        if p.dim() == 0 or p.shape[0] <= rows:
            upd(*leaves)
            continue
        for i in range(0, p.shape[0], rows):
            upd(*(a[i:i + rows] for a in leaves))
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
