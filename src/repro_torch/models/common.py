"""Shared building blocks: parameter metadata and init, norms, rotary
embeddings, softcap and SwiGLU, in PyTorch.

Parameters live in a flat dict ``{name: tensor}``; every module contributes
``ParamMeta`` (shape, init rule, scale) and ``init_params`` materialises
them with the reference's std rule (``scale / sqrt(fan_in)``, ones for
norms) from an explicit ``torch.Generator``. ``cross_entropy`` is the
training loss. The numbers differ from JAX's
threefry draws; the tests carry the reference's weights across instead
(``weights.params_from_jax``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | small
    scale: float = 1.0


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
    (N, V) one-hot)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0].float()
    return (lse - ll).mean()
