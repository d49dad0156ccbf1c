"""Plain PyTorch versions of the two attention kernels.

They define what ``csrc/flash_prefill.cu`` and ``csrc/paged_decode.cu``
compute: the wrappers run them for tensors on the CPU, the tests hold them
against ``repro.kernels.ref`` and the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card. Softmax and both products
run in float32, as the TPU kernels do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
POS_INVALID = 2 ** 30          # key position sentinel: masked by causality


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else cap * torch.tanh(x / cap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Sk,K,hd) with H a multiple of K (GQA).

    Masking modes, as in the reference: implicit iota causal/window
    (Sq == Sk); ``segment_ids`` (B,S) block-diagonal; explicit
    ``q_positions``/``kv_positions`` (B,Sq)/(B,Sk), Sq != Sk allowed, with
    invalid keys at ``POS_INVALID``; ``kv_segment_ids`` (B,Sk) gives the
    key axis its own segments. Out in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    if q_positions is not None:
        ii = q_positions[:, :, None]
        jj = kv_positions[:, None, :]
        mask = jj < POS_INVALID
    else:
        assert Sq == Sk, "rectangular attention requires explicit positions"
        ii = torch.arange(Sq, device=q.device)[None, :, None]
        jj = torch.arange(Sk, device=q.device)[None, None, :]
        mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (jj <= ii)
    if window is not None:
        mask = mask & (jj > ii - window)
    if segment_ids is not None:
        seg_k = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = mask & (segment_ids[:, :, None] == seg_k[:, None, :])
    mask = mask.expand(B, Sq, Sk)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention over a paged KV cache.

    q (B,H,hd); k/v_pages (P,page,K,hd); block_tables (B,MP) int32;
    context_lens (B,) int32. Returns (B,H,hd). A row with context 0 gives
    zeros, as the kernel does (the JAX oracle gives the mean of V there)."""
    B, H, hd = q.shape
    P, page, K, _ = k_pages.shape
    G = H // K
    mp = block_tables.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt].reshape(B, mp * page, K, hd).float()
    vg = v_pages[bt].reshape(B, mp * page, K, hd).float()
    qf = q.float().reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qf, kg) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    ctx = context_lens.long()
    valid = torch.arange(mp * page, device=q.device)[None, :] < ctx[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, vg)
    out = torch.where((ctx > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, H, hd).to(q.dtype)


def kv_page_append(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   block_tables: torch.Tensor, positions: torch.Tensor):
    """Write one new token's K/V per row into the paged cache, in place.

    k_new/v_new (B,K,hd); positions (B,) absolute token index. Returns the
    (updated) pages. The reference returns new arrays; here the pages are
    written in place, where JAX would donate them."""
    page = k_pages.shape[1]
    pos = positions.long()
    bidx = torch.arange(k_new.shape[0], device=k_new.device)
    pids = block_tables.long()[bidx, pos // page]
    k_pages.index_put_((pids, pos % page), k_new.to(k_pages.dtype))
    v_pages.index_put_((pids, pos % page), v_new.to(v_pages.dtype))
    return k_pages, v_pages
