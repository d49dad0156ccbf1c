"""Model assembly for pure-attention (``ATTN``) decoder stacks: parameters,
caches, prefill, decode and logits, mirroring ``repro.models.model``.

Parameters live in a flat dict ``{name: tensor}`` with every per-layer
weight stacked along a leading layer axis (L, ...); the forward passes are a
Python loop over layers where the reference scans, each layer's weights a
view into the stacked tensor. Caches are ``{"A": {"k", "v"}}`` with leaves
(L, B, C, K, hd), as the reference's ``init_cache``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import attention, mlp
from .common import ParamMeta, ParamTree, init_params, rms_norm
from .config import ATTN, ModelConfig

Params = Dict[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# per-layer parameter names of an ATTN block: attention weights come from
# ``attention.attn_params``, MLP weights from ``mlp.mlp_params``
ATTN_NORM, MLP_NORM = "attn_norm", "mlp_norm"


def check_supported(cfg: ModelConfig) -> None:
    """This slice runs dense pure-attention stacks only."""
    kinds = set(cfg.pattern())
    if kinds != {ATTN}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} (Mamba2/xLSTM) are not "
            f"ported yet (ROADMAP queue 1: other model families)")
    if cfg.shared_attention_every:
        raise NotImplementedError(
            f"{cfg.name}: shared attention is not ported yet (ROADMAP "
            f"queue 1: other model families)")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE is not ported yet (ROADMAP queue 1: other "
            f"model families)")


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# --------------------------------------------------------------------------- #
# parameters and caches
# --------------------------------------------------------------------------- #
def param_tree(cfg: ModelConfig) -> ParamTree:
    check_supported(cfg)
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    t: ParamTree = {"tok_embed": ParamMeta((v, d))}
    block = {ATTN_NORM: ParamMeta((d,), init="ones")}
    block.update(attention.attn_params(cfg))
    block[MLP_NORM] = ParamMeta((d,), init="ones")
    block.update(mlp.mlp_params(cfg))
    for k, m in block.items():
        t[k] = ParamMeta((L,) + m.shape, init=m.init, scale=m.scale)
    t["final_norm"] = ParamMeta((d,), init="ones")
    if not cfg.tie_embeddings:
        t["head"] = ParamMeta((d, v))
    return t


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Seeded random weights (``scale/sqrt(fan_in)``, ones for norms)."""
    device = torch.device(device) if device is not None else gen.device
    return init_params(param_tree(cfg), gen, dtype_of(cfg.param_dtype),
                       device)


def layer_params(params: Params, cfg: ModelConfig, layer: int) -> Params:
    """Views of one layer's weights into the stacked tensors."""
    return {k: params[k][layer] for k in _layer_names(cfg)}


def _layer_names(cfg: ModelConfig):
    return [ATTN_NORM, *attention.attn_params(cfg), MLP_NORM,
            *mlp.mlp_params(cfg)]


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
               device=None) -> Cache:
    """Decode caches at a context capacity (window-clamped)."""
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    C = min(capacity, cfg.sliding_window) if cfg.sliding_window else capacity
    shape = (cfg.num_layers, batch, C, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {ATTN: {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def seed_cache(cfg: ModelConfig, cache: Cache, prefill_caches: Cache,
               prompt_len: int) -> Cache:
    """Copy prefill K/V into a decode cache of larger capacity, in place:
    token p at slot p (the last C tokens at ring slots p % C when the
    prompt is longer than a windowed cache)."""
    for n in ("k", "v"):
        dst, src = cache[ATTN][n], prefill_caches[ATTN][n]
        C, S = dst.shape[2], src.shape[2]
        if S <= C:
            dst[:, :, :S] = src.to(dst.dtype)
        else:
            dst.copy_(torch.roll(src[:, :, S - C:], shifts=(S - C) % C,
                                 dims=2))
    return cache


# --------------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------------- #
def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    return params["tok_embed"][tokens.long()].to(dtype_of(cfg.dtype))


def logits_fn(cfg: ModelConfig, params: Params, x: torch.Tensor
              ) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head


def prefill_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   prefix_caches: Optional[Cache] = None, prefix_len=None,
                   prefix_positions: Optional[torch.Tensor] = None,
                   prefix_segment_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """The stack without the final norm and head: (hidden (B,S,d), caches
    holding this call's K/V, leaves (L,B,S,K,hd)). Arguments as ``prefill``."""
    check_supported(cfg)
    if prefix_caches is not None:
        assert positions is not None
        assert (prefix_len is not None) or (
            prefix_positions is not None and prefix_segment_ids is not None)
        assert segment_ids is None or prefix_positions is not None, \
            "a packed chunk wave needs per-slot prefix positions"
    x = embed(cfg, params, tokens)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        p = layer_params(params, cfg, layer)
        h = rms_norm(x, p[ATTN_NORM], cfg.rms_eps)
        pk = pv = None
        if prefix_caches is not None:
            pk = prefix_caches[ATTN]["k"][layer]
            pv = prefix_caches[ATTN]["v"][layer]
        y, (k, v) = attention.attn_prefill(
            p, cfg, h, positions, segment_ids=segment_ids, prefix_k=pk,
            prefix_v=pv, prefix_len=prefix_len,
            prefix_positions=prefix_positions,
            prefix_segment_ids=prefix_segment_ids)
        x = x + y
        x = x + mlp.mlp_apply(p, rms_norm(x, p[MLP_NORM], cfg.rms_eps))
        ks.append(k)
        vs.append(v)
    return x, {ATTN: {"k": torch.stack(ks), "v": torch.stack(vs)}}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, last_only: bool = False,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            prefix_caches: Optional[Cache] = None, prefix_len=None,
            prefix_positions: Optional[torch.Tensor] = None,
            prefix_segment_ids: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits, caches holding the prompt's K/V). ``last_only``
    projects only the final position.

    Token-packed prefill: ``segment_ids`` (B,S) plus ``positions`` that
    restart at 0 per segment. Chunked prefill: ``prefix_caches`` (the
    request's seeded cache rows, (L,B,C,K,hd)) plus scalar ``prefix_len``
    and absolute ``positions``; the returned caches hold the chunk's K/V
    only. Packed chunk waves: ``segment_ids`` and per-slot
    ``prefix_positions``/``prefix_segment_ids`` (B,C) instead."""
    if embeds is not None:
        raise NotImplementedError(
            "embedding frontends are not ported yet (ROADMAP queue 1: other "
            "model families)")
    x, caches = prefill_hidden(cfg, params, tokens, positions, segment_ids,
                               prefix_caches, prefix_len, prefix_positions,
                               prefix_segment_ids)
    if last_only:
        return logits_fn(cfg, params, x[:, -1]), caches
    return logits_fn(cfg, params, x), caches


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                pos: torch.Tensor, caches: Cache,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,1); pos (B,) absolute positions. Writes each row's new K/V
    into ``caches`` in place (only rows where ``active``, when given) and
    returns (logits (B,V), caches)."""
    check_supported(cfg)
    x = embed(cfg, params, tokens)
    ck, cv = caches[ATTN]["k"], caches[ATTN]["v"]
    for layer in range(cfg.num_layers):
        p = layer_params(params, cfg, layer)
        h = rms_norm(x, p[ATTN_NORM], cfg.rms_eps)
        x = x + attention.attn_decode(p, cfg, h, pos, ck[layer], cv[layer],
                                      active=active)
        x = x + mlp.mlp_apply(p, rms_norm(x, p[MLP_NORM], cfg.rms_eps))
    return logits_fn(cfg, params, x[:, 0]), caches
