"""GQA attention with RoPE and optional qk-norm, in PyTorch.

Two entry points, mirroring ``repro.models.attention``:
  * ``attn_prefill`` — attention over a whole (possibly token-packed or
    chunked) sequence; returns the layer output and the K/V to seed a cache.
  * ``attn_decode``  — one new token per row against its cache row, which it
    updates in place.

All core attention goes through ``repro_torch.kernels.ops``: the CUDA
kernels on the card, their plain versions on the CPU. Activations are
(B, S, H, hd) and weights ``x @ W`` with W (d_in, d_out), as the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import POS_INVALID
from .common import ParamMeta, ParamTree, apply_rope, rms_norm
from .config import ModelConfig


def attn_params(cfg: ModelConfig, *, kv_heads: Optional[int] = None
                ) -> ParamTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh = cfg.num_heads
    nkv = kv_heads or cfg.num_kv_heads
    t: ParamTree = {
        "wq": ParamMeta((d, nh * hd)),
        "wk": ParamMeta((d, nkv * hd)),
        "wv": ParamMeta((d, nkv * hd)),
        "wo": ParamMeta((nh * hd, d)),
    }
    if cfg.use_qk_norm:
        t["q_norm"] = ParamMeta((hd,), init="ones")
        t["k_norm"] = ParamMeta((hd,), init="ones")
    return t


def _project_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, positions: torch.Tensor, nkv: int):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, nkv, hd)
    v = (x @ p["wv"]).reshape(B, S, nkv, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunk_kv_masks(B: int, C: int, positions: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None, *,
                   prefix_len=None,
                   prefix_positions: Optional[torch.Tensor] = None,
                   prefix_segment_ids: Optional[torch.Tensor] = None):
    """Key-axis positions and segment ids of a chunk call whose keys are a
    C-slot cache prefix followed by the chunk's own S tokens. The prefix is
    valid below scalar ``prefix_len``, or where ``prefix_positions`` (B,C)
    is not POS_INVALID. Returns (kpos (B,C+S), kseg (B,C+S) or None)."""
    S = positions.shape[-1]
    if prefix_positions is not None:
        kpos_prefix = prefix_positions.expand(B, C)
    else:
        slot = torch.arange(C, device=positions.device)
        kpos_prefix = torch.where(slot < prefix_len, slot,
                                  POS_INVALID)[None].expand(B, C)
    kpos = torch.cat([kpos_prefix.to(positions.dtype),
                      positions.expand(B, S)], dim=1)
    kseg = None
    if segment_ids is not None:
        kseg = torch.cat([prefix_segment_ids.expand(B, C).to(
            segment_ids.dtype), segment_ids.expand(B, S)], dim=1)
    return kpos, kseg


def attn_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *,
                 segment_ids: Optional[torch.Tensor] = None,
                 kv_heads: Optional[int] = None,
                 prefix_k: Optional[torch.Tensor] = None,
                 prefix_v: Optional[torch.Tensor] = None,
                 prefix_len=None,
                 prefix_positions: Optional[torch.Tensor] = None,
                 prefix_segment_ids: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Forms, as in the reference (``attention.py:175-265``):

    * plain: implicit causal attention over x;
    * ``segment_ids`` (B,S): token-packed prompts attend block-diagonally,
      ``positions`` restarting per segment;
    * ``prefix_k``/``prefix_v`` (B,C,K,hd) + scalar ``prefix_len``: a chunk
      attends over the first ``prefix_len`` slots of a seeded cache row and
      causally over itself (``positions`` absolute);
    * packed chunks: ``segment_ids`` plus per-slot ``prefix_positions`` /
      ``prefix_segment_ids`` (B,C) instead of ``prefix_len``.

    Returns (y (B,S,d), (k, v) of the chunk itself)."""
    B, S, _ = x.shape
    nkv = kv_heads or cfg.num_kv_heads
    q, k, v = _project_qkv(p, cfg, x, positions, nkv)
    if prefix_k is not None:
        kpos, kseg = chunk_kv_masks(
            B, prefix_k.shape[1], positions, segment_ids,
            prefix_len=prefix_len, prefix_positions=prefix_positions,
            prefix_segment_ids=prefix_segment_ids)
        k_all = torch.cat([prefix_k.to(k.dtype), k], dim=1)
        v_all = torch.cat([prefix_v.to(v.dtype), v], dim=1)
        out = ops.flash_attention(q, k_all, v_all, segment_ids,
                                  positions.expand(B, S), kpos, kseg,
                                  causal=True, window=cfg.sliding_window,
                                  softcap=cfg.attn_logit_softcap)
    else:
        out = ops.flash_attention(q, k, v, segment_ids, causal=True,
                                  window=cfg.sliding_window,
                                  softcap=cfg.attn_logit_softcap)
    y = out.reshape(B, S, -1) @ p["wo"]
    return y, (k, v)


def attn_decode(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                kv_heads: Optional[int] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode. x (B,1,d); pos (B,) absolute position of the new
    token; cache_k/v (B,C,K,hd), C = full context or the sliding window.

    The new K/V are written into the cache rows first (in place, where the
    reference returns updated arrays from a donated buffer), then the token
    attends. ``active`` (B,) bool restricts the write to those rows: an
    inactive slot may hold a queued request's live KV. Returns y (B,1,d)."""
    B = x.shape[0]
    C = cache_k.shape[1]
    nkv = kv_heads or cfg.num_kv_heads
    q, k, v = _project_qkv(p, cfg, x, pos[:, None], nkv)

    windowed = cfg.sliding_window is not None and C == cfg.sliding_window
    slot = (pos % C if windowed else torch.clamp(pos, max=C - 1)).long()
    bidx = torch.arange(B, device=x.device)
    k_new, v_new = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
    if active is not None:
        # masked write without a host sync: inactive rows rewrite their
        # own current value
        m = active[:, None, None]
        k_new = torch.where(m, k_new, cache_k[bidx, slot])
        v_new = torch.where(m, v_new, cache_v[bidx, slot])
    cache_k[bidx, slot] = k_new
    cache_v[bidx, slot] = v_new
    # every written slot is valid; softmax is permutation-invariant, so
    # ring-buffer slot order does not matter — a count suffices
    n_valid = torch.clamp(pos + 1, max=C) if windowed else pos + 1
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, n_valid,
                               softcap=cfg.attn_logit_softcap)[:, None]
    return out.reshape(B, 1, -1) @ p["wo"]
