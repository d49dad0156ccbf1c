"""Carry the reference's weights into the port.

``params_from_jax`` takes the reference's flat ``{path: array}`` dict
(``repro.models.model.param_tree`` paths, as numpy arrays) and returns the
port's parameters; ``params_to_jax`` is its inverse (gradients are compared
through it, and checkpoints carry the reference's names). The path-to-name
mapping lives in ``JAX_TO_PORT``, and only there. bfloat16 goes through
float32, which is exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# reference path -> port name. Per-layer entries of a kind are stacked
# (n, ...) on both sides, n the layers of that kind; the shared block is not
# stacked. The layouts are the same (``x @ W`` with W (d_in, d_out)).
JAX_TO_PORT: Dict[str, str] = {
    "embed/tok": "tok_embed",
    "A/norm1": "attn_norm",
    "A/attn/wq": "wq",
    "A/attn/wk": "wk",
    "A/attn/wv": "wv",
    "A/attn/wo": "wo",
    "A/attn/q_norm": "q_norm",
    "A/attn/k_norm": "k_norm",
    "A/norm2": "mlp_norm",
    "A/mlp/w_gate": "w_gate",
    "A/mlp/w_up": "w_up",
    "A/mlp/w_down": "w_down",
    # a MoE block's experts and router (Arctic's dense residual beside them
    # keeps the ``A/mlp/*`` names)
    "A/moe/router": "moe.router",
    "A/moe/w_gate": "moe.w_gate",
    "A/moe/w_up": "moe.w_up",
    "A/moe/w_down": "moe.w_down",
    "final_norm": "final_norm",
    "head": "head",
    # the recurrent kinds and the shared block, each under its own prefix.
    # A cell's own norm scale (``ssm/norm``, ``cell/norm``) is the port's
    # ``gate_norm`` / ``out_norm``, apart from the block's pre-norm ``norm``
    "M/norm": "mamba.norm",
    "M/ssm/in_proj": "mamba.in_proj",
    "M/ssm/conv_w": "mamba.conv_w",
    "M/ssm/conv_b": "mamba.conv_b",
    "M/ssm/A_log": "mamba.A_log",
    "M/ssm/D": "mamba.D",
    "M/ssm/dt_bias": "mamba.dt_bias",
    "M/ssm/norm": "mamba.gate_norm",
    "M/ssm/out_proj": "mamba.out_proj",
    "X/norm": "mlstm.norm",
    "X/cell/wq": "mlstm.wq",
    "X/cell/wk": "mlstm.wk",
    "X/cell/wv": "mlstm.wv",
    "X/cell/wi": "mlstm.wi",
    "X/cell/wf": "mlstm.wf",
    "X/cell/bf": "mlstm.bf",
    "X/cell/wo": "mlstm.wo",
    "X/cell/norm": "mlstm.out_norm",
    "X/cell/down": "mlstm.down",
    "S/norm": "slstm.norm",
    "S/cell/w_in": "slstm.w_in",
    "S/cell/r": "slstm.r",
    "S/cell/b": "slstm.b",
    "S/cell/norm": "slstm.out_norm",
    "S/cell/down": "slstm.down",
    "shared/norm1": "shared.attn_norm",
    "shared/attn/wq": "shared.wq",
    "shared/attn/wk": "shared.wk",
    "shared/attn/wv": "shared.wv",
    "shared/attn/wo": "shared.wo",
    "shared/attn/q_norm": "shared.q_norm",
    "shared/attn/k_norm": "shared.k_norm",
    "shared/norm2": "shared.mlp_norm",
    "shared/mlp/w_gate": "shared.w_gate",
    "shared/mlp/w_up": "shared.w_up",
    "shared/mlp/w_down": "shared.w_down",
}


def params_from_jax(flat: Dict[str, np.ndarray], *, device,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Map a reference parameter dict onto the port's names, as tensors of
    ``dtype`` on ``device``. Every reference path must be known."""
    unknown = sorted(set(flat) - set(JAX_TO_PORT))
    if unknown:
        raise NotImplementedError(
            f"reference parameters with no port counterpart: {unknown}")
    out = {}
    for path, arr in flat.items():
        a = np.array(arr, dtype=np.float32)    # bf16 -> f32 is exact
        out[JAX_TO_PORT[path]] = torch.from_numpy(a).to(device=device,
                                                        dtype=dtype)
    return out



PORT_TO_JAX: Dict[str, str] = {v: k for k, v in JAX_TO_PORT.items()}


def jax_names(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same tensors under the reference's paths."""
    unknown = sorted(set(params) - set(PORT_TO_JAX))
    if unknown:
        raise NotImplementedError(
            f"port parameters with no reference counterpart: {unknown}")
    return {PORT_TO_JAX[n]: t for n, t in params.items()}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: a port parameter (or gradient)
    dict as the reference's ``{path: float32 array}``."""
    return {path: t.detach().float().cpu().numpy()
            for path, t in jax_names(params).items()}
