"""Paged decode attention: the wrapper of ``csrc/paged_decode.cu``.

A CUDA tensor launches the hand-written kernels (built on first use) or
raises; a CPU tensor takes the plain version in ``ref.py``; any other
device raises, and so does an input that requires grad while grad is
enabled; a fake tensor (a ``FakeTensorMode`` trace) gets an empty
output. ``paged_decode_attention.launches`` counts launches of the
split-KV kernel; each is followed by one launch of its combine kernel,
counted in ``paged_decode_attention.combine_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import ref, refuse_grad, traced

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 112, 128, 160)   # 64-160: every config's hd
MAX_GROUP = 16          # query heads per kv head the kernel holds
SPLIT_ALIGN = 64        # split lengths are multiples of this
CTAS_PER_SM = 4         # split-KV aims at this many CTAs per SM
H100_SMS = 132


def plan_splits(batch: int, kv_heads: int, capacity: int,
                n_sm: int = H100_SMS) -> Tuple[int, int]:
    """(keys per split, number of splits) for a decode call over rows of
    ``capacity`` key slots. Shapes only: the context lengths live on the
    card, and reading them would need a host sync."""
    want = max(1, -(-CTAS_PER_SM * n_sm // (batch * kv_heads)))
    split = -(-capacity // want)
    split = max(SPLIT_ALIGN, -(-split // SPLIT_ALIGN) * SPLIT_ALIGN)
    return split, -(-capacity // split)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    from .build import load
    lib = load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            block_tables: Optional[torch.Tensor], context_lens: torch.Tensor,
            page: int, MP: int, softcap: Optional[float]) -> torch.Tensor:
    """Launch the split-KV kernel and its combine on q's card. A null
    ``block_tables`` addresses row b's key t at page b*MP + t/page."""
    B, H, hd = q.shape
    K = k_pages.shape[-2]
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 "
                        f"of one dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if hd not in _HEAD_DIMS or H % K or H // K > MAX_GROUP \
            or v_pages.shape != k_pages.shape or k_pages.shape[-1] != hd \
            or context_lens.shape != (B,):
        raise ValueError(
            f"paged_decode_attention: unsupported shapes q {tuple(q.shape)} "
            f"pages {tuple(k_pages.shape)}")
    dev = q.device
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    bt = None if block_tables is None else block_tables.to(
        device=dev, dtype=torch.int32).contiguous()
    cl = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    split, n_split = plan_splits(B, K, MP * page, _sm_count(dev.index or 0))
    part = torch.empty(B * K * n_split * (H // K) * (hd + 2),
                       dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 None if bt is None else bt.data_ptr(), cl.data_ptr(),
                 out.data_ptr(), part.data_ptr(), B, H, K, hd, page, MP,
                 split, n_split, _DTYPES[q.dtype], float(softcap or 0.0),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    paged_decode_attention.combine_launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q (B,H,hd); k/v_pages (P,page,K,hd); block_tables (B,MP) int32;
    context_lens (B,) int32. Returns (B,H,hd) in q's dtype."""
    refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    if traced(q):
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          context_lens, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: no kernel for device {q.device}")
    if k_pages.dim() != 4 or block_tables.shape[0] != q.shape[0]:
        raise ValueError(
            f"paged_decode_attention: unsupported shapes q {tuple(q.shape)} "
            f"pages {tuple(k_pages.shape)} tables "
            f"{tuple(block_tables.shape)}")
    return _launch(q, k_pages, v_pages, block_tables, context_lens,
                   k_pages.shape[1], block_tables.shape[1], softcap)


def decode_rows(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                context_lens: torch.Tensor, page: int, *,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention over contiguous per-request rows, cache_k/v
    (B,C,K,hd). On the card the kernel addresses row b's slots directly
    (no block table is built); on the CPU the plain version reads the rows
    as C/page pages under an identity table."""
    refuse_grad("decode_rows", q, cache_k, cache_v)
    if traced(q):
        return torch.empty_like(q)
    B, C, K, hd = cache_k.shape
    if q.device.type == "cuda":
        if cache_k.dim() != 4 or cache_k.shape[0] != q.shape[0]:
            raise ValueError(f"decode_rows: unsupported shapes q "
                             f"{tuple(q.shape)} cache {tuple(cache_k.shape)}")
        return _launch(q, cache_k, cache_v, None, context_lens, C, 1, softcap)
    mp = C // page
    bt = (torch.arange(B, device=q.device)[:, None] * mp
          + torch.arange(mp, device=q.device)[None, :]).to(torch.int32)
    return paged_decode_attention(
        q, cache_k.reshape(B * mp, page, K, hd),
        cache_v.reshape(B * mp, page, K, hd), bt,
        context_lens.to(torch.int32), softcap=softcap)


paged_decode_attention.launches = 0
paged_decode_attention.combine_launches = 0
