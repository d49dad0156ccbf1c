"""Public attention ops, mirroring ``repro.kernels.ops``.

Every call goes to one of the two kernel wrappers, which launch the CUDA
kernel for a CUDA tensor and run the plain version for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_prefill import flash_attention as _flash
from .paged_attention import paged_decode_attention as _paged


def flash_attention(q, k, v, segment_ids=None, q_positions=None,
                    kv_positions=None, kv_segment_ids=None, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Prefill attention. q (B,Sq,H,hd); k/v (B,Sk,K,hd).

    ``segment_ids`` (B,S) makes the mask block-diagonal (token-packed
    prefill); ``q_positions``/``kv_positions`` (B,Sq)/(B,Sk) switch to
    explicit-position masking with Sq != Sk allowed (chunked prefill over a
    cache-prefix view); ``kv_segment_ids`` (B,Sk) gives the key axis its own
    segments (packed multi-request chunks)."""
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                  segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
                  q_positions=q_positions, kv_positions=kv_positions)


def paged_decode_attention(q, k_pages, v_pages, block_tables, context_lens,
                           *, softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """Decode attention over an explicitly paged cache."""
    return _paged(q, k_pages, v_pages, block_tables, context_lens,
                  softcap=softcap)


def page_size(C: int) -> int:
    """Largest of 128/64/32/16/8 that divides C, else C."""
    for ps in (128, 64, 32, 16, 8):
        if C % ps == 0:
            return ps
    return C


def decode_attention(q, cache_k, cache_v, context_lens, *,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a contiguous per-request cache row.

    q (B,H,hd); cache_k/v (B,C,K,hd); context_lens (B,) valid slots. Each
    row is viewed (without a copy) as C/page pages under an identity block
    table."""
    B, C, K, hd = cache_k.shape
    ps = page_size(C)
    mp = C // ps
    kp = cache_k.reshape(B * mp, ps, K, hd)
    vp = cache_v.reshape(B * mp, ps, K, hd)
    bt = (torch.arange(B, device=q.device)[:, None] * mp
          + torch.arange(mp, device=q.device)[None, :]).to(torch.int32)
    return _paged(q, kp, vp, bt, context_lens.to(torch.int32),
                  softcap=softcap)
