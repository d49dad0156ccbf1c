"""Paged decode attention: the wrapper of ``csrc/paged_decode.cu``.

A CUDA tensor launches the hand-written kernels (built on first use) or
raises; a CPU tensor takes the plain version in ``ref.py``; any other
device raises, and so does an input that requires grad while grad is
enabled; a fake tensor (a ``FakeTensorMode`` trace) gets an empty
output. ``paged_decode_attention.launches`` counts launches of the
split-KV kernel, one a call: it merges its splits itself (the last CTA of
each row and kv head, elected through a counter the wrapper keeps per
device and stream). ``plan`` gives a call's split and the bf16 kernel's
copy ("tma" boxes, or "cp.async" for pages under a block table that are
not a multiple of 8 slots), tiles, stages and shared memory;
``paged_decode_attention.plans`` logs the bf16 plans the launches used.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..obs.spans import spanned
from . import ref, refuse_grad, traced

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 112, 128, 160)   # 64-160: every config's hd
MAX_GROUP = 16          # query heads per kv head the kernel holds
TILE = 64               # keys a tile; split lengths are multiples of it
MAX_STAGES = 4
THREADS = 160           # a consumer warpgroup and the producer warp
SMEM_SM = 233472        # shared memory of an SM, 1024 bytes of it held a CTA
N_SM = 132              # SMs of the H100 SXM


def group(G: int) -> int:
    """The query heads a kv head the bf16 kernel is built for: 4, 8, 16."""
    return 4 if G <= 4 else 8 if G <= 8 else MAX_GROUP


def smem_bytes(hd: int, G: int, stages: int) -> int:
    """Dynamic shared memory of the bf16 kernel (``DecCfg::bytes``):
    alignment slack, the ring of K and V tiles (64-column boxes of 64 keys,
    128 bytes a row), Q^T (the heads padded to 8), P (hi and lo rows of
    each head), the max and sum exchange, two barriers a stage."""
    nb, gb = -(-hd // 64), group(G)
    return (1024 + stages * 2 * nb * TILE * 128 + nb * max(8, gb) * 128
            + 2 * gb * 128 + 2 * 4 * MAX_GROUP * 4 + 16 * stages)


def plan(batch: int, heads: int, kv_heads: int, hd: int, capacity: int,
         page: int, n_sm: int = N_SM) -> dict:
    """The launch plan of a decode call over rows of ``capacity`` key
    slots in pages of ``page`` (``page == capacity``: contiguous rows).
    Shapes only: the context lengths live on the card, and reading them
    would need a host sync.

    The bf16 kernel keeps as many K/V stages as let two CTAs share an SM,
    up to MAX_STAGES; ``ctas_per_sm`` is then how many CTAs of that shared
    memory really fit. The grid (``n_split`` splits of ``split`` keys for
    each of the batch x kv-head rows) fills one wave of those resident
    CTAs: as many splits as one wave holds, or one split when the rows
    alone fill it (two waves were slower or no faster at every serving
    shape: PERF.md). The producer copies K and V by TMA (``copy`` "tma")
    in boxes of ``box`` rows: the tile under contiguous rows (or one
    page), else the largest power of two that divides both the page and
    the tile, so that no box crosses a page. A 128-byte-swizzled box
    holds whole 8-row atoms, so pages that are not a multiple of 8 slots
    are copied a key row at a time by cp.async instead (``copy``
    "cp.async", ``box`` None), into the same swizzled tiles."""
    if hd not in _HEAD_DIMS or heads % kv_heads or \
            heads // kv_heads > MAX_GROUP or capacity < 1 or page < 1:
        raise ValueError(f"paged decode plan: unsupported heads {heads} / "
                         f"{kv_heads} at hd {hd}, capacity {capacity}, "
                         f"page {page}")
    G = heads // kv_heads
    stages = max(s for s in range(2, MAX_STAGES + 1)
                 if 2 * (smem_bytes(hd, G, s) + 1024) <= SMEM_SM)
    smem = smem_bytes(hd, G, stages)
    ctas = min(SMEM_SM // (smem + 1024), 2048 // THREADS)
    slots = ctas * n_sm
    rows = batch * kv_heads
    want = max(1, slots // rows)
    split = -(-capacity // want)
    split = -(-split // TILE) * TILE
    n_split = -(-capacity // split)
    box = TILE if page >= capacity else math.gcd(page, TILE)
    copy = "tma" if box % 8 == 0 else "cp.async"
    return {"tile": TILE, "copy": copy,
            "box": box if copy == "tma" else None, "stages": stages,
            "smem": smem,
            "threads": THREADS, "group": group(G), "ctas_per_sm": ctas,
            "split": split, "n_split": n_split, "grid": rows * n_split,
            "waves": rows * n_split / slots}


# the wrapper's plans, by call shape (a decode step calls one shape a layer)
_plan = functools.lru_cache(maxsize=None)(plan)
# (device, stream) -> the kernel's split counters: zero between calls
# (the merging CTA puts its counter back), so calls on one stream share
# them. Calls that share a buffer must run one after another: a CUDA graph
# keeps the buffer of the stream it was captured on, and replayed beside
# eager calls or another graph of that stream, two kernels would take
# tickets from one counter and elect the wrong merger. The engine's decode
# graphs (``serving/decode_graphs.py``) leave this kernel out of every
# graph and launch it eagerly between replays, on one stream.
_COUNTERS: dict = {}


def _counters(dev: torch.device, stream: int, n: int) -> int:
    """The address of ``n`` zeroed int32 split counters for calls on
    ``stream`` of ``dev``, grown (and zeroed) on first need."""
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    from .build import load
    lib = load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            block_tables: Optional[torch.Tensor], context_lens: torch.Tensor,
            page: int, MP: int, softcap: Optional[float],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the split-KV kernel on q's card, writing ``out`` (a new
    tensor when None). A null ``block_tables`` (MP = 1) reads row b's keys
    from contiguous rows (B, page, K, hd)."""
    B, H, hd = q.shape
    K = k_pages.shape[-2]
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 "
                        f"of one dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if hd not in _HEAD_DIMS or H % K or H // K > MAX_GROUP \
            or v_pages.shape != k_pages.shape or k_pages.shape[-1] != hd \
            or context_lens.shape != (B,) or (out is not None and (
                out.shape != q.shape or out.dtype != q.dtype
                or out.device != q.device or not out.is_contiguous()
                or out.data_ptr() % 16)):
        raise ValueError(
            f"paged_decode_attention: unsupported shapes q {tuple(q.shape)} "
            f"pages {tuple(k_pages.shape)}")
    dev = q.device
    p = _plan(B, H, K, hd, MP * page, page, _sm_count(dev.index or 0))
    bf16 = q.dtype == torch.bfloat16
    # the bf16 kernel reads q in 16-byte chunks and K/V by TMA or
    # cp.async from 16-byte aligned bases
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if bf16 and (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        q, k_pages, v_pages = (t if t.data_ptr() % 16 == 0 else t.clone()
                               for t in (q, k_pages, v_pages))
    bt = None if block_tables is None else block_tables.to(
        device=dev, dtype=torch.int32).contiguous()
    cl = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    split, n_split = p["split"], p["n_split"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = cnt = None
    if n_split > 1:
        part = torch.empty(B * K * n_split * (H // K) * (hd + 2),
                           dtype=torch.float32, device=dev)
        cnt = _counters(dev, stream, B * K)
    if out is None:
        out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 None if bt is None else bt.data_ptr(), cl.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(),
                 cnt, B, H, K, hd, page, MP,
                 k_pages.shape[0], split, n_split, p["stages"], p["box"] or 0,
                 _DTYPES[q.dtype], float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    paged_decode_attention.launches += 1
    if bf16:
        key = (split, n_split, p["stages"], p["box"])
        plans = paged_decode_attention.plans
        plans[key] = plans.get(key, 0) + 1
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


@spanned("kernels.decode_call")
def decode_rows(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                context_lens: torch.Tensor, page: int, *,
                softcap: Optional[float] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over contiguous per-request rows, cache_k/v
    (B,C,K,hd). On the card the kernel addresses row b's slots directly
    (no block table is built) and writes ``out`` (B,H,hd), contiguous, of
    q's dtype, when given; on the CPU the plain version reads the rows as
    C/page pages under an identity table and its result is copied into
    ``out``."""
    refuse_grad("decode_rows", q, cache_k, cache_v)
    if traced(q):
        return torch.empty_like(q) if out is None else out
    B, C, K, hd = cache_k.shape
    if q.device.type == "cuda":
        if cache_k.dim() != 4 or cache_k.shape[0] != q.shape[0]:
            raise ValueError(f"decode_rows: unsupported shapes q "
                             f"{tuple(q.shape)} cache {tuple(cache_k.shape)}")
        return _launch(q, cache_k, cache_v, None, context_lens, C, 1, softcap,
                       out)
    mp = C // page
    bt = (torch.arange(B, device=q.device)[:, None] * mp
          + torch.arange(mp, device=q.device)[None, :]).to(torch.int32)
    res = paged_decode_attention(
        q, cache_k.reshape(B * mp, page, K, hd),
        cache_v.reshape(B * mp, page, K, hd), bt,
        context_lens.to(torch.int32), softcap=softcap)
    return res if out is None else out.copy_(res)


_ERRORS = {1001: "the driver has no cuTensorMapEncodeTiled",
           1002: "the driver refused a TMA tensor map"}
paged_decode_attention.launches = 0
# (split, n_split, stages, box) -> bf16 launches
paged_decode_attention.plans = {}
