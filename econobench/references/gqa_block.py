"""Plain float32 forward of a decoder of GQA attention blocks: the
reference that decides ``correct`` for the configurations that name it.

Pre-RMSNorm blocks; attention with RoPE (half-split rotation), grouped
kv heads and a causal softmax over the whole sequence; a SwiGLU
feed-forward; final RMSNorm and an untied head. It reads the port's
parameter names and layout ((..., d_in, d_out) matrices, layers stacked
first) and nothing else of the port: it imports neither the port nor its
kernels.

Weights are taken in whatever dtype they are served in and widened to
float32 one layer at a time, and every product runs in float32 with TF32
off. ``mode`` rounds both operands of every matrix product first, and
computes the product in float32: ``"fp8"`` is the control, the step below
the configuration's bf16 (float8 e4m3, one scale per output column of a
weight and per row of an activation, as an fp8 GEMM takes them);
``"bf16"`` is a witness, the same arithmetic at the served precision.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
HEAD_GROUP = 8          # query heads whose scores are held at once


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, mode: str, dim: int) -> torch.Tensor:
    """x rounded to ``mode`` (e4m3 with one scale along ``dim``, or
    bf16), back in float32."""
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, mode) -> torch.Tensor:
    """x (N, d_in) @ w (d_in, d_out) in float32, both operands rounded
    first under ``mode``."""
    w = w.float()
    if mode is None:
        return x @ w
    return _round(x, mode, -1) @ _round(w, mode, -2)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, heads, hd), pos (N,): rotate the two halves of hd."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                         device=x.device) / hd)
    ang = (pos.double()[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, groups: int) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, hd), k/v (S, K, hd)."""
    S, H, hd = q.shape
    k = k.repeat_interleave(groups, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(groups, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h in range(0, H, HEAD_GROUP):
        s = q[h:h + HEAD_GROUP] @ k[h:h + HEAD_GROUP].transpose(1, 2) \
            / hd ** 0.5
        s = s.masked_fill(~mask, float("-inf"))
        out[h:h + HEAD_GROUP] = torch.softmax(s, dim=-1) @ v[h:h + HEAD_GROUP]
    return out.transpose(0, 1)


def _swiglu(h, wg, wu, wd, mode):
    return _mm(F.silu(_mm(h, wg, mode)) * _mm(h, wu, mode), wd, mode)


def logits(cfg: dict, p: Dict[str, torch.Tensor], seqs: List[torch.Tensor],
           rows: List[torch.Tensor], *, mode=None) -> List[torch.Tensor]:
    """float32 logits of each sequence ``seqs[i]`` (token ids, (S_i,)) at
    the positions ``rows[i]``: a list of (len(rows[i]), V)."""
    no_tf32()
    dev = p["tok_embed"].device
    seqs = [s.to(dev) for s in seqs]
    lens = [len(s) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    x = torch.cat([p["tok_embed"][s].float() for s in seqs])
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    H, K, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    eps = cfg["eps"]
    for i in range(cfg["layers"]):
        h = _rms(x, p["attn_norm"][i], eps)
        q = _rope(_mm(h, p["wq"][i], mode).view(-1, H, hd), pos,
                  cfg["rope_theta"])
        k = _rope(_mm(h, p["wk"][i], mode).view(-1, K, hd), pos,
                  cfg["rope_theta"])
        v = _mm(h, p["wv"][i], mode).view(-1, K, hd)
        o = torch.cat([_attend(q[a:b], k[a:b], v[a:b], H // K)
                       for a, b in zip(offs, offs[1:])])
        x = x + _mm(o.reshape(-1, H * hd), p["wo"][i], mode)
        h = _rms(x, p["mlp_norm"][i], eps)
        x = x + _swiglu(h, p["w_gate"][i], p["w_up"][i], p["w_down"][i], mode)
    sel = torch.cat([a + r.to(dev) for a, r in zip(offs, rows)])
    out = _mm(_rms(x[sel], p["final_norm"], eps), p["head"], mode)
    return list(out.split([len(r) for r in rows]))
