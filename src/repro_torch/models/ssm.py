"""Mamba2 (SSD) block in PyTorch, mirroring ``repro.models.ssm``: the
chunked matmul form for prefill, the one-step recurrence for decode.

Layout as the reference, with n_groups = 1:
  in_proj -> [z (di), x (di), B (n), C (n), dt (nh)]
  causal conv1d over [x, B, C]; SSD; gated RMSNorm; out_proj.

The reference computes the SSD in ``jnp`` einsums outside any Pallas
kernel, so this module is plain PyTorch too. The 4-operand contraction of
the intra-chunk term is written as explicit pairwise products (C B^T, then
the decay mask, then a batched matmul with x dt), so no (B, nc, Q, Q, nh,
hd) intermediate is ever formed. The state ``h`` stays float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.dtensor import (blockwise, is_dtensor, merge_heads,
                                   rows_heads)
from .common import EMBED, INNER, NUL, ParamMeta, ParamTree, rms_norm
from .config import ModelConfig


def ssm_dims(cfg: ModelConfig):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    n = cfg.ssm_state
    conv_dim = di + 2 * n
    return di, nh, n, conv_dim


def ssm_params(cfg: ModelConfig) -> ParamTree:
    """The reference's ``ssm_params``; its gated-norm scale ``norm`` is
    ``gate_norm`` here, apart from the block's own pre-norm."""
    d = cfg.d_model
    di, nh, n, conv_dim = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    return {
        "in_proj": ParamMeta((d, 2 * di + 2 * n + nh), (EMBED, INNER)),
        "conv_w": ParamMeta((w, conv_dim), (NUL, INNER), init="small"),
        "conv_b": ParamMeta((conv_dim,), (INNER,), init="zeros"),
        "A_log": ParamMeta((nh,), (NUL,), init="ones"),
        "D": ParamMeta((nh,), (NUL,), init="ones"),
        "dt_bias": ParamMeta((nh,), (NUL,), init="zeros"),
        "gate_norm": ParamMeta((di,), (INNER,), init="ones"),
        "out_proj": ParamMeta((di, d), (INNER, EMBED)),
    }


def _split_proj(p, cfg: ModelConfig, u: torch.Tensor):
    di, nh, n, _ = ssm_dims(cfg)
    return torch.split(u @ p["in_proj"], [di, di, n, n, nh], dim=-1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l) lower-tri seg[i,j] = sum_{j+1..i} a."""
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    l = a.shape[-1]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssm_prefill(p, cfg: ModelConfig, u: torch.Tensor, init=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u (B,S,d). Returns (y (B,S,d), cache {h, conv}). The sequence is
    padded to a multiple of ``ssm_chunk`` with dt = 0 on the padded steps
    (the state is left untouched). ``init`` (a previous call's cache, or a
    decode cache) resumes the recurrence: its conv history seeds the causal
    conv window and its ``h`` the inter-chunk scan."""
    B, S0, _ = u.shape
    di, nh, n, conv_dim = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S0)
    S = -(-S0 // Q) * Q

    z, xs, Bm, Cm, dt = _split_proj(p, cfg, u)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                     # (B,S0,conv)
    w = cfg.ssm_conv_width
    history = init["conv"].to(xbc.dtype) if init is not None else \
        torch.zeros((B, w - 1, conv_dim), dtype=xbc.dtype, device=u.device)
    conv_cache = torch.cat([history, xbc], dim=1)[:, S0:]
    if S != S0:
        z, xs, Bm, Cm, dt, xbc = (F.pad(t, (0, 0, 0, S - S0))
                                  for t in (z, xs, Bm, Cm, dt, xbc))
    xbc_pad = torch.cat([history, xbc], dim=1)
    conv = 0
    for i in range(w):           # the reference's summation order
        conv = conv + xbc_pad[:, i:i + S] * p["conv_w"][w - 1 - i]
    conv = F.silu(conv + p["conv_b"])
    xs, Bm, Cm = torch.split(conv, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    if S != S0:
        dt = dt * (torch.arange(S, device=u.device) < S0)[None, :, None]
    A = -torch.exp(p["A_log"].float())                        # (nh,)
    xh = xs.reshape(B, S, nh, hd).float()
    h0 = init["h"].float() if init is not None else None
    args = (xh, dt, A, Bm.float(), Cm.float(), p["D"].float(), h0, Q)
    if is_dtensor(xh):      # under a mesh: each rank's rows and heads
        y, h = rows_heads(_ssd, args, ((0, 2), (0, 2), (None, 0), (0, None),
                                       (0, None), (None, 0), (0, 1), None),
                          ((0, 2), (0, 1)))
    else:
        y, h = _ssd(*args)
    y = merge_heads(y).to(u.dtype)[:, :S0]

    y = rms_norm(y * F.silu(z[:, :S0]), p["gate_norm"], cfg.rms_eps)
    return y @ p["out_proj"], {"h": h, "conv": conv_cache}


def _ssd(xh, dt, A, Bm, Cm, D, h0, Q: int):
    """The chunked SSD over chunks of Q steps: xh (B,S,nh,hd), dt (B,S,nh),
    A and D (nh,), Bm/Cm (B,S,n) float32; h0 (B,nh,hd,n) or None (zero).
    Returns (y (B,S,nh,hd), the final state h)."""
    B, S, nh, hd = xh.shape
    n, nc = Bm.shape[-1], S // Q
    c = lambda t: t.reshape(B, nc, Q, *t.shape[2:])
    dt_c, x_c = c(dt), c(xh)                                 # (B,nc,Q,nh[,hd])
    B_c, C_c = c(Bm), c(Cm)                                  # (B,nc,Q,n)
    a_c = dt_c * A                                           # (B,nc,Q,nh)
    a_cum = torch.cumsum(a_c, dim=2)
    L = torch.exp(_segsum(a_c.permute(0, 1, 3, 2)))          # (B,nc,nh,Q,Q)
    xdt = x_c * dt_c[..., None]                              # (B,nc,Q,nh,hd)
    xdt_h = xdt.permute(0, 1, 3, 2, 4)                       # (B,nc,nh,Q,hd)

    # y_diag[l,h,p] = sum_s (C_l . B_s) L[h,l,s] xdt[s,h,p]
    cb = C_c @ B_c.transpose(-1, -2)                         # (B,nc,Q,Q)
    y_diag = (cb[:, :, None] * L) @ xdt_h                    # (B,nc,nh,Q,hd)
    decay_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)       # (B,nc,Q,nh)
    # states[h,p,n] = sum_l xdt[l,h,p] decay_end[l,h] B[l,n]
    states = (xdt * decay_end[..., None]).permute(0, 1, 3, 4, 2) \
        @ B_c[:, :, None]                                    # (B,nc,nh,hd,n)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])              # (B,nc,nh)

    h = h0 if h0 is not None else \
        torch.zeros((B, nh, hd, n), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,nh,hd,n)

    in_decay = torch.exp(a_cum)                              # (B,nc,Q,nh)
    # y_off[l,h,p] = sum_n C[l,n] h_prev[h,p,n] in_decay[l,h]
    y_off = (h_prevs @ C_c[:, :, None].transpose(-1, -2))    # (B,nc,nh,hd,Q)
    y_off = y_off.permute(0, 1, 4, 2, 3) * in_decay[..., None]
    y = (y_diag.permute(0, 1, 3, 2, 4) + y_off).reshape(B, S, nh, hd) \
        + D[None, None, :, None] * xh
    return y, h


def ssm_decode(p, cfg: ModelConfig, u: torch.Tensor,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u (B,1,d); cache {'h': (B,nh,hd,n) fp32, 'conv': (B,w-1,conv_dim)}.
    Returns (y (B,1,d), the new cache) without touching ``cache``."""
    B = u.shape[0]
    di, nh, n, conv_dim = ssm_dims(cfg)
    hd = cfg.ssm_head_dim

    z, xs, Bm, Cm, dt = _split_proj(p, cfg, u)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]              # (B,conv)
    hist = torch.cat([cache["conv"].to(xbc.dtype), xbc[:, None]], dim=1)
    # the prefill's convention: conv_w[0] weights the newest token
    conv = (blockwise(lambda t: torch.flip(t, dims=(1,)), hist, dims=(1,))
            * p["conv_w"]).sum(dim=1) \
        + p["conv_b"]
    conv = F.silu(conv)
    xs, Bm, Cm = torch.split(conv, [di, n, n], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,nh)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)
    xh = xs.reshape(B, nh, hd).float()
    Bf, Cf = Bm.float(), Cm.float()                          # (B,n)

    h = cache["h"] * dA[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bf[:, None, None, :]
    # on a DTensor the contraction over n stays elementwise: a matmul
    # would flatten (B, nh), sharded over data and model, into one dim
    hC = (h * Cf[:, None, None, :]).sum(-1) if is_dtensor(h) \
        else (h @ Cf[:, None, :, None])[..., 0]
    y = hC + p["D"].float()[None, :, None] * xh
    y = merge_heads(y).reshape(B, 1, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.rms_eps)
    return y @ p["out_proj"], {"h": h, "conv": hist[:, 1:]}


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    di, nh, n, conv_dim = ssm_dims(cfg)
    return {"h": torch.zeros((batch, nh, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype, device=device)}
