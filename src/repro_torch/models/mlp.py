"""Dense SwiGLU MLP."""
from __future__ import annotations

import torch

from .common import ParamMeta, ParamTree, swiglu
from .config import ModelConfig


def mlp_params(cfg: ModelConfig, d_ff: int = 0) -> ParamTree:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamMeta((d, f)),
        "w_up": ParamMeta((d, f)),
        "w_down": ParamMeta((f, d)),
    }


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
