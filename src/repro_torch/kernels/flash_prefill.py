"""Flash prefill attention: the wrapper of ``csrc/flash_prefill.cu``.

A CUDA tensor launches the hand-written kernel (built on first use) or
raises; a CPU tensor takes the plain version in ``ref.py``; any other
device raises. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
TILE = 64               # q rows and keys a tile of the kernel


def _lib():
    from .build import load
    lib = load("flash_prefill")
    fn = lib.flash_prefill
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _i32(a: Optional[torch.Tensor], shape, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = a.to(device=device, dtype=torch.int32).expand(shape).contiguous()
    return a


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Sk,K,hd), H a multiple of K. Masks as in
    ``ref.flash_attention``. Returns (B,Sq,H,hd) in q's dtype."""
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions go together")
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if q_positions is None and Sq != Sk:
        raise ValueError("rectangular attention requires explicit positions")
    if q.device.type == "cpu":
        return ref.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            q_positions=q_positions, kv_positions=kv_positions)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS or H % K or v.shape != k.shape \
            or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = q.device
    seg_q = _i32(segment_ids, (B, Sq), dev)
    seg_k = _i32(kv_segment_ids if kv_segment_ids is not None
                 else segment_ids, (B, Sk), dev)
    pos_q = _i32(q_positions, (B, Sq), dev)
    pos_k = _i32(kv_positions, (B, Sk), dev)
    out = torch.empty_like(q)
    tiles = torch.empty(B * (4 * -(-Sq // TILE) + 5 * -(-Sk // TILE)),
                        dtype=torch.int32, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ptr(seg_q), ptr(seg_k), ptr(pos_q), ptr(pos_k),
                 tiles.data_ptr(), B, Sq, Sk, H, K, hd, _DTYPES[q.dtype],
                 int(causal), int(window or 0), float(softcap or 0.0),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
