"""Paged decode attention: the wrapper of ``csrc/paged_decode.cu``.

A CUDA tensor launches the hand-written kernel (built on first use) or
raises; a CPU tensor takes the plain version in ``ref.py``; any other
device raises. ``paged_decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16          # query heads per kv head the kernel holds


def _lib():
    from .build import load
    lib = load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q (B,H,hd); k/v_pages (P,page,K,hd); block_tables (B,MP) int32;
    context_lens (B,) int32. Returns (B,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          context_lens, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: no kernel for device {q.device}")
    B, H, hd = q.shape
    P, page, K, _ = k_pages.shape
    MP = block_tables.shape[1]
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 "
                        f"of one dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if hd not in _HEAD_DIMS or H % K or H // K > MAX_GROUP \
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd \
            or block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(
            f"paged_decode_attention: unsupported shapes q {tuple(q.shape)} "
            f"pages {tuple(k_pages.shape)} tables {tuple(block_tables.shape)}")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    cl = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 bt.data_ptr(), cl.data_ptr(), out.data_ptr(), B, H, K, hd,
                 page, MP, _DTYPES[q.dtype], float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
