"""Dense SwiGLU MLP."""
from __future__ import annotations

import torch

from .common import EMBED, MLP, ParamMeta, ParamTree, swiglu
from .config import ModelConfig


def mlp_params(cfg: ModelConfig, d_ff: int = 0) -> ParamTree:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamMeta((d, f), (EMBED, MLP)),
        "w_up": ParamMeta((d, f), (EMBED, MLP)),
        "w_down": ParamMeta((f, d), (MLP, EMBED)),
    }


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
