"""Public attention ops, mirroring ``repro.kernels.ops``.

Every call goes to one of the two kernel wrappers, which launch the CUDA
kernel for a CUDA tensor and run the plain version for a CPU tensor. Under a
mesh the model hands these ops DTensors: the core then runs inside
``local_map`` on each rank's block of heads (and rows), where the wrappers
see plain tensors. Query heads shard over ``model`` only when the kv heads
do too (each rank then holds whole GQA groups); otherwise the heads are
replicated over ``model`` for the call, where the reference relies on
GSPMD's padding.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.dtensor import (all_gather_dim, is_dtensor, replicated,
                                   rows_heads)
from .flash_prefill import flash_attention as _flash
from .paged_attention import decode_rows as _decode_rows
from .paged_attention import paged_decode_attention as _paged


class _DenseGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a region's
    local gradient goes back into a DTensor, whose later views assume a
    dense local block."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def heads_region(fn, q, k, v, ints=()) -> torch.Tensor:
    """``fn(q, k, v, *ints)`` on DTensors, as a ``local_map`` region over
    each rank's block of rows and heads (``dtensor.rows_heads``): q/k/v
    (B,S,heads,hd) over (rows, heads), the (B,S) int arrays (or None) over
    rows. Differentiable: the local output and the local gradients of
    q/k/v are dense."""
    def local(q, k, v, *ints):
        if torch.is_grad_enabled():
            q, k, v = (_DenseGrad.apply(t) if t.requires_grad else t
                       for t in (q, k, v))
        return fn(q, k, v, *ints).contiguous()

    return rows_heads(local, (q, k, v, *ints),
                      ((0, 2),) * 3 + ((0, None),) * len(ints), ((0, 2),))


def _decode_sharded(q, cache_k, cache_v, context_lens, softcap
                    ) -> torch.Tensor:
    """``decode_attention`` on DTensor caches, in their own layout: q and
    ``context_lens`` follow the cache's rows (and q its kv heads); a cache
    sharded along its slots or head dim is gathered whole inside the
    region before the kernel runs."""
    mesh = cache_k.device_mesh
    pl = cache_k.placements
    q_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
            else Replicate() for p in pl]
    n_pl = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    gather = [(md, p.dim) for md, p in enumerate(pl)
              if p.is_shard() and p.dim in (1, 3)]

    def local(q, ck, cv, n):
        for md, dim in reversed(gather):
            ck = all_gather_dim(ck, dim, mesh, md)
            cv = all_gather_dim(cv, dim, mesh, md)
        return _decode_rows(q, ck, cv, n, page_size(ck.shape[1]),
                            softcap=softcap)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, pl, pl, n_pl), device_mesh=mesh,
                     redistribute_inputs=True)(
        q, cache_k, cache_v, replicated(context_lens, mesh))


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
    if is_dtensor(q):
        def local(q, k, v, seg, qpos, kpos, kseg):
            return _flash(q, k, v, segment_ids=seg, kv_segment_ids=kseg,
                          q_positions=qpos, kv_positions=kpos, causal=causal,
                          window=window, softcap=softcap)
        return heads_region(local, q, k, v, (segment_ids, q_positions,
                                             kv_positions, kv_segment_ids))
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
                     softcap: Optional[float] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over a contiguous per-request cache row.

    q (B,H,hd); cache_k/v (B,C,K,hd); context_lens (B,) valid slots. On the
    card the kernel addresses each row's slots directly, with no block
    table; the plain version views each row (without a copy) as C/page
    pages under an identity block table. ``out`` (B,H,hd) of q's dtype, if
    given, receives the result (not under a mesh)."""
    if is_dtensor(cache_k):
        if out is not None:
            raise ValueError("decode_attention: no out= under a mesh")
        return _decode_sharded(q, cache_k, cache_v, context_lens, softcap)
    return _decode_rows(q, cache_k, cache_v, context_lens,
                        page_size(cache_k.shape[1]), softcap=softcap,
                        out=out)
