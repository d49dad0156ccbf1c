"""Carry the reference's weights into the port.

``params_from_jax`` takes the reference's flat ``{path: array}`` dict
(``repro.models.model.param_tree`` paths, as numpy arrays) and returns the
port's parameters. The path-to-name mapping lives in ``JAX_TO_PORT``, and
only there. bfloat16 goes through float32, which is exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# reference path -> port name. Per-layer entries are stacked (L, ...) on
# both sides; the layouts are the same (``x @ W`` with W (d_in, d_out)).
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
    "final_norm": "final_norm",
    "head": "head",
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

