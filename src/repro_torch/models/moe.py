"""Top-k MoE with capacity-based scatter dispatch, in PyTorch: the port of
``repro.models.moe.moe_apply`` on one device (the reference's ``D = 1``
path; its shard_map branches wait for the sharding slice).

Dispatch is sort-free, as the reference's: each (token, slot) assignment's
position within its expert comes from a one-hot cumsum over the call's
flattened assignments (token-major), assignments at or past the expert's
capacity are dropped, and the kept tokens are scattered into an (E, C, d)
buffer that every expert runs as one batched SwiGLU. The capacity depends
on the call's token count (``capacity``), so a MoE call's output depends on
its shape and on where pad tokens sit: the engine runs MoE stacks at the
reference's padded shapes.

Where the reference scatters with ``mode="drop"`` and gathers with
``mode="fill"``, the buffer here has one more column: dropped assignments
land in column C, which is cut off before the experts run and is zero when
the outputs are gathered back. The expert contraction is a plain batched
product, as in the reference (no Pallas kernel there).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ParamMeta, ParamTree
from .config import ModelConfig


def moe_params(cfg: ModelConfig) -> ParamTree:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    return {
        "router": ParamMeta((d, e), init="small"),
        "w_gate": ParamMeta((e, d, f)),
        "w_up": ParamMeta((e, d, f)),
        "w_down": ParamMeta((e, f, d)),
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


def _expert_ffn(p: Dict[str, torch.Tensor], buf: torch.Tensor
                ) -> torch.Tensor:
    """SwiGLU of every expert over its rows: buf (E, C, d) -> (E, C, d)."""
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def moe_apply(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux load-balance loss, a float32 scalar)."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.num_experts
    C = capacity(cfg, T)
    xf = x.reshape(T, d)

    logits = xf.float() @ p["router"].float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, k)                                 # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, slot) assignment within its expert
    e_flat = idx.reshape(T * k)
    onehot = F.one_hot(e_flat, E)                               # (T*k, E)
    pos = (onehot.cumsum(0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = pos < C
    pos_s = torch.where(keep, pos, torch.full_like(pos, C))     # drop -> C

    t_flat = torch.arange(T * k, device=x.device) // k
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[e_flat, pos_s] = xf[t_flat]
    out = _expert_ffn(p, buf[:, :C])
    out = torch.cat([out, out.new_zeros((E, 1, d))], dim=1)     # fill = 0
    yv = out[e_flat, pos_s]                                     # (T*k, d)
    w = (gate.reshape(T * k) * keep).to(x.dtype)
    y = (yv * w[:, None]).reshape(T, k, d).sum(dim=1).reshape(B, S, d)

    # Switch-style load-balance aux loss
    frac_tokens = onehot.float().mean(0) * k
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
