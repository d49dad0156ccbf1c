"""Flash prefill attention: the wrapper of ``csrc/flash_prefill.cu``.

A CUDA tensor launches the hand-written kernel (built on first use) or
raises; a CPU tensor takes the plain version in ``ref.py``; any other
device raises, and so does an input that requires grad while grad is
enabled; a fake tensor (a ``FakeTensorMode`` trace) gets an empty
output. ``flash_attention.launches`` counts kernel launches. ``plan``
gives the bf16 kernel's tile sizes, stages and shared memory for a call;
``flash_attention.plans`` logs the plans the launches used.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..obs.spans import spanned
from . import ref, refuse_grad, traced

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 112, 128, 160)   # 64-160: every config's hd
TILE = 64               # q rows and keys a tile of the pre-pass (and f32)
SMEM_MAX = 232448       # shared memory a block can use on the H100
N_SM = 132              # SMs of the H100 SXM
MAX_STAGES = 4
LONG_WAVES = 8          # 128-row tiles an SM from which two consumers pay


def plan(batch: int, sq: int, sk: int, heads: int, hd: int, *,
         positions: bool = False, segments: bool = False,
         block_q: Optional[int] = None) -> dict:
    """The bf16 kernel's launch plan for q (batch, sq, heads, hd) over sk
    keys, with or without explicit positions and segment ids.

    Two consumer warpgroups (128 q rows a CTA, 128 keys a tile) for long
    calls, whose grid of 128-row tiles covers every SM at least
    ``LONG_WAVES`` times; else one (64 q rows, 64 keys, two CTAs an SM),
    which spreads short calls over twice the CTAs. hd 160 always takes two
    consumers and 64 keys: one consumer's 128 registers a thread do not
    hold its accumulators (ptxas spills and serialises the wgmma), nor
    does shared memory hold two 128-key stages. As many K/V stages as fit
    in shared memory, up to MAX_STAGES (two for one consumer, so that two
    CTAs share an SM). ``smem`` repeats ``WgCfg::bytes`` of the kernel.
    ``block_q`` (64 or 128) overrides the choice of q rows where the head
    dim has both tiles (hd up to 128), for tests of both."""
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"flash plan: head dim {hd} is not a multiple of "
                         f"16 up to 256")
    if block_q not in (None, 64, 128):
        raise ValueError(f"flash plan: block_q {block_q} is not 64 or 128")
    if hd > 128:
        nc = 2
    elif block_q:
        nc = block_q // 64
    else:
        nc = 2 if -(-sq // 128) * heads * batch >= LONG_WAVES * N_SM else 1
    bn = 128 if nc == 2 and hd <= 128 else 64
    nb = -(-hd // 64)                           # 64-wide boxes of hd
    q_bytes = nb * 64 * nc * 128
    # K, V, key positions / segments, four barriers
    stage = 2 * nb * bn * 128 + 4 * bn * (positions + segments) + 32

    def smem(stages):
        return 1024 + q_bytes + stages * stage + 8 + 4 * (16 + nc
                                                          + -(-sk // bn))

    top = MAX_STAGES if nc == 2 else 2
    stages = max((s for s in range(2, top + 1) if smem(s) <= SMEM_MAX),
                 default=None)
    if stages is None:
        raise ValueError(f"flash plan: sk {sk} at hd {hd} needs "
                         f"{smem(2)} bytes of shared memory")
    return {"block_q": 64 * nc, "block_k": bn, "stages": stages,
            "consumers": nc, "threads": 128 * (nc + 1), "smem": smem(stages)}


def _lib():
    from .build import load
    lib = load("flash_prefill")
    fn = lib.flash_prefill
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_int] * 3)
        fn.restype = ctypes.c_int
    return fn


def _i32(a: Optional[torch.Tensor], shape, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = a.to(device=device, dtype=torch.int32).expand(shape).contiguous()
    return a


@spanned("kernels.flash_call")
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
    refuse_grad("flash_attention", q, k, v)
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions go together")
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if q_positions is None and Sq != Sk:
        raise ValueError("rectangular attention requires explicit positions")
    if traced(q):
        return torch.empty_like(q)
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
    # TMA reads from 16-byte aligned bases
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
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
    p = plan(B, Sq, Sk, H, hd, positions=pos_q is not None,
             segments=seg_q is not None) if q.dtype == torch.bfloat16 else None
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ptr(seg_q), ptr(seg_k), ptr(pos_q), ptr(pos_k),
                 tiles.data_ptr(), B, Sq, Sk, H, K, hd, _DTYPES[q.dtype],
                 int(causal), int(window or 0), float(softcap or 0.0),
                 torch.cuda.current_stream(dev).cuda_stream,
                 *((p["block_q"], p["block_k"], p["stages"]) if p
                   else (0, 0, 0)))
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    flash_attention.launches += 1
    if p:
        key = (p["block_q"], p["block_k"], p["stages"])
        flash_attention.plans[key] = flash_attention.plans.get(key, 0) + 1
    return out


_ERRORS = {1001: "the driver has no cuTensorMapEncodeTiled",
           1002: "the driver refused a TMA tensor map"}
flash_attention.launches = 0
flash_attention.plans = {}  # (block_q, block_k, stages) -> bf16 launches
