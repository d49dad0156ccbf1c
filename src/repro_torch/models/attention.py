"""GQA attention with RoPE and optional qk-norm, in PyTorch.

Two entry points, mirroring ``repro.models.attention``:
  * ``attn_prefill`` — attention over a whole (possibly token-packed or
    chunked) sequence; returns the layer output and the K/V to seed a cache.
  * ``attn_decode``  — one new token per row against its cache row, which it
    updates in place; ``attn_decode_pieces`` is the same as a program cut
    at its paged-decode call (``DecodeCall``), which ``run_calls`` runs.

All core attention of these two goes through ``repro_torch.kernels.ops``:
the CUDA kernels on the card, their plain versions on the CPU. Training
takes a third, ``attn_train``: the reference's differentiable XLA attention
(``sdpa``, and ``flash_xla`` above ``FLASH_THRESHOLD`` tokens), which
reaches no kernel, as the reference's training path reaches none.
Activations are (B, S, H, hd) and weights ``x @ W`` with W (d_in, d_out),
as the reference.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..distributed.dtensor import (is_dtensor, merge_heads, replicated,
                                   split_heads)
from ..kernels import ops
from ..kernels.ref import NEG_INF, POS_INVALID
from .common import (EMBED, HEADS, KV, NUL, ParamMeta, ParamTree, apply_rope,
                     rms_norm, softcap)
from .config import ModelConfig

# sequences longer than this take ``flash_xla`` in training (the dense S^2
# ``sdpa`` below it), as the reference's XLA branch of ``attn_prefill``;
# ``flash_xla`` works in the reference's q and k blocks
FLASH_THRESHOLD = 2048
BLOCK_Q, BLOCK_K = 512, 1024


def attn_params(cfg: ModelConfig, *, kv_heads: Optional[int] = None
                ) -> ParamTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh = cfg.num_heads
    nkv = kv_heads or cfg.num_kv_heads
    t: ParamTree = {
        "wq": ParamMeta((d, nh * hd), (EMBED, HEADS)),
        "wk": ParamMeta((d, nkv * hd), (EMBED, KV)),
        "wv": ParamMeta((d, nkv * hd), (EMBED, KV)),
        "wo": ParamMeta((nh * hd, d), (HEADS, EMBED)),
    }
    if cfg.use_qk_norm:
        t["q_norm"] = ParamMeta((hd,), (NUL,), init="ones")
        t["k_norm"] = ParamMeta((hd,), (NUL,), init="ones")
    return t


def _project_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, positions: torch.Tensor, nkv: int):
    hd = cfg.resolved_head_dim
    q = split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = split_heads(x @ p["wk"], nkv, hd)
    v = split_heads(x @ p["wv"], nkv, hd)
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
    y = merge_heads(out) @ p["wo"]
    return y, (k, v)


def _write_slot_sharded(cache, slot, new) -> None:
    """``cache[b, slot[b]] = new[b]`` in place on a DTensor cache (B,C,K,hd)
    in its own layout: each rank writes its block. ``new`` (B,K,hd) and
    ``slot`` (B,) are laid out to follow the cache's rows, kv heads and head
    dim; along a cache sharded by slots only the rank that holds the slot
    writes it (the others rewrite their own value, with no host sync)."""
    mesh, pl = cache.device_mesh, cache.placements
    # cache dims (B,C,K,hd) -> new's (B,K,hd); a slot shard replicates
    new_pl = [Shard(max(0, p.dim - 1)) if p.is_shard() and p.dim != 1
              else Replicate() for p in pl]
    slot_pl = [p if p == Shard(0) else Replicate() for p in pl]
    c = cache.to_local()
    n = new.redistribute(mesh, new_pl).to_local()
    s = replicated(slot, mesh).redistribute(mesh, slot_pl).to_local()
    coord, off = mesh.get_coordinate(), 0
    for md, p in enumerate(pl):
        if p.is_shard() and p.dim == 1:
            off = off * mesh.size(md) + coord[md]
    Cl = c.shape[1]
    ls = s.long() - off * Cl
    mine = (ls >= 0) & (ls < Cl)
    ls = ls.clamp(0, Cl - 1)
    b = torch.arange(c.shape[0], device=c.device)
    c[b, ls] = torch.where(mine[:, None, None], n.to(c.dtype), c[b, ls])


class DecodeCall(NamedTuple):
    """One attention layer's paged-decode call in a decode step: q
    (B,H,hd), the layer's cache rows (B,C,K,hd) with the step's new K/V
    written, the step's positions (B,), whether the rows are a
    sliding-window ring of C slots, and the logit softcap."""
    q: torch.Tensor
    cache_k: torch.Tensor
    cache_v: torch.Tensor
    pos: torch.Tensor
    ring: bool
    softcap: Optional[float]

    @property
    def lens_key(self) -> Tuple[int, bool]:
        """What ``lens`` depends on besides ``pos``."""
        return self.cache_k.shape[1], self.ring

    def lens(self) -> torch.Tensor:
        """Each row's valid slots (B,): every written slot. Softmax is
        permutation-invariant, so a ring's slot order does not matter and a
        count (at most C) suffices."""
        C = self.cache_k.shape[1]
        return torch.clamp(self.pos + 1, max=C) if self.ring \
            else self.pos + 1

    def run(self, lens: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The call, eagerly: (B,H,hd), written into ``out`` when given;
        ``lens`` defaults to ``self.lens()``."""
        return ops.decode_attention(
            self.q, self.cache_k, self.cache_v,
            self.lens() if lens is None else lens, softcap=self.softcap,
            out=out)


def run_calls(prog):
    """Run a decode program (``attn_decode_pieces``,
    ``model.decode_pieces``): each ``DecodeCall`` it yields runs eagerly
    and its output is sent back. Returns the program's value."""
    out = None
    while True:
        try:
            call = prog.send(out)
        except StopIteration as done:
            return done.value
        out = call.run()


def attn_decode_pieces(p, cfg: ModelConfig, x: torch.Tensor,
                       pos: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, *,
                       kv_heads: Optional[int] = None,
                       active: Optional[torch.Tensor] = None):
    """``attn_decode`` as a program (a generator) cut at its paged-decode
    call: it writes the new K/V, yields the ``DecodeCall`` and takes the
    call's output (B,H,hd) back, then restores the inactive rows' slots
    and returns y (B,1,d)."""
    B = x.shape[0]
    C = cache_k.shape[1]
    nkv = kv_heads or cfg.num_kv_heads
    q, k, v = _project_qkv(p, cfg, x, pos[:, None], nkv)

    windowed = cfg.sliding_window is not None and C == cfg.sliding_window
    slot = (pos % C if windowed else torch.clamp(pos, max=C - 1)).long()
    bidx = torch.arange(B, device=x.device)
    k_new, v_new = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
    if is_dtensor(cache_k):
        if active is not None:
            raise NotImplementedError("a sharded decode writes every row")
        _write_slot_sharded(cache_k, slot, k_new)
        _write_slot_sharded(cache_v, slot, v_new)
    else:
        if active is not None:
            # the gathers copy the slots' old values, with no host sync
            old_k, old_v = cache_k[bidx, slot], cache_v[bidx, slot]
        cache_k[bidx, slot] = k_new
        cache_v[bidx, slot] = v_new
    out = (yield DecodeCall(q[:, 0], cache_k, cache_v, pos, windowed,
                            cfg.attn_logit_softcap))[:, None]
    if active is not None:
        m = active[:, None, None]
        cache_k[bidx, slot] = torch.where(m, k_new, old_k)
        cache_v[bidx, slot] = torch.where(m, v_new, old_v)
    return merge_heads(out) @ p["wo"]


def attn_decode(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                kv_heads: Optional[int] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode. x (B,1,d); pos (B,) absolute position of the new
    token; cache_k/v (B,C,K,hd), C = full context or the sliding window.

    The new K/V are written into the cache rows first (in place, where the
    reference returns updated arrays from a donated buffer), then the token
    attends. With ``active`` (B,) bool every row still writes and attends
    over its own new K/V, as the reference's rows do, and the inactive rows'
    slots get their old values back afterwards, bit for bit (the reference's
    engine drops those writes after the step): an inactive slot may hold a
    queued request's live KV. Returns y (B,1,d)."""
    return run_calls(attn_decode_pieces(p, cfg, x, pos, cache_k, cache_v,
                                        kv_heads=kv_heads, active=active))


# --------------------------------------------------------------------------- #
# training: the reference's XLA attention, differentiable
# --------------------------------------------------------------------------- #
def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``_sdpa``: q (B,Sq,H,hd), k/v (B,Sk,K,hd), mask
    (B,Sq,Sk) bool. float32 logits (products of the stored values), the
    softcap, ``NEG_INF`` where masked, and the softmax weights cast to V's
    dtype before PV, which accumulates in float32."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) \
        / hd ** 0.5
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _flash_q_block(qi, pqi, ks, vs, pks, cfg: ModelConfig):
    """One q block of ``flash_xla`` against every k block: online softmax,
    all in float32. qi (B,bq,K,G,hd), pqi (B,bq); ks/vs/pks lists of k
    blocks. Returns (B,bq,K,G,hd)."""
    B, bq, K, G, hd = qi.shape
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((B, K, G, bq), NEG_INF, device=qi.device)
    l = torch.zeros((B, K, G, bq), device=qi.device)
    acc = torch.zeros((B, K, G, bq, hd), device=qi.device)
    ii = pqi[:, None, None, :, None]
    for kj, vj, pkj in zip(ks, vs, pks):
        s = torch.einsum("bskgh,btkh->bkgst", qi, kj) * scale
        s = softcap(s, cfg.attn_logit_softcap)
        jj = pkj[:, None, None, None, :]
        mask = jj <= ii
        if cfg.sliding_window is not None:
            mask = mask & (jj > ii - cfg.sliding_window)
        s = torch.where(mask, s, NEG_INF)
        # amax spreads the gradient over ties, as jnp.max does
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh", p,
                                                    vj)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4)


def flash_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos_q: torch.Tensor, pos_k: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The reference's ``_flash_jnp`` without segments: streaming attention
    over ``BLOCK_Q`` x ``BLOCK_K`` tiles with an online softmax in float32,
    each q block under ``torch.utils.checkpoint`` (recomputed in the
    backward pass, as the reference checkpoints ``q_step``). Pad queries
    take position -1 and pad keys ``POS_INVALID``, so neither is seen."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    bq, bk = min(BLOCK_Q, Sq), min(BLOCK_K, Sk)
    pq, pk = (-Sq) % bq, (-Sk) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        pos_q = F.pad(pos_q, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        pos_k = F.pad(pos_k, (0, pk), value=POS_INVALID)
    qs = q.reshape(B, -1, bq, K, H // K, hd).unbind(1)
    pqs = pos_q.reshape(B, -1, bq).unbind(1)
    ks = k.reshape(B, -1, bk, K, hd).unbind(1)
    vs = v.reshape(B, -1, bk, K, hd).unbind(1)
    pks = pos_k.reshape(B, -1, bk).unbind(1)
    outs = [checkpoint(_flash_q_block, qi, pqi, ks, vs, pks, cfg,
                       use_reentrant=False, preserve_rng_state=False)
            for qi, pqi in zip(qs, pqs)]
    out = torch.cat(outs, dim=1).reshape(B, -1, H, hd)
    return out[:, :Sq].to(dtype)


def attn_train(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               *, kv_heads: Optional[int] = None) -> torch.Tensor:
    """Causal (and windowed) attention of the training forward, the
    reference's ``attn_prefill`` on its XLA branch: ``flash_xla`` when
    S > ``FLASH_THRESHOLD``, else ``sdpa`` under the position mask.
    Differentiable; calls no kernel. Returns y (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, kv_heads or cfg.num_kv_heads)

    def core(q, k, v, positions):
        if S > FLASH_THRESHOLD:
            return flash_xla(q, k, v, positions, positions, cfg)
        ii, jj = positions[:, :, None], positions[:, None, :]
        mask = jj <= ii
        if cfg.sliding_window is not None:
            mask = mask & (jj > ii - cfg.sliding_window)
        return sdpa(q, k, v, mask, cfg)

    # under a mesh the core runs on each rank's rows and heads
    out = ops.heads_region(core, q, k, v, (positions,)) if is_dtensor(q) \
        else core(q, k, v, positions)
    return merge_heads(out) @ p["wo"]
