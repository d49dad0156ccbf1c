"""Peaks of the chip, and the operations and bytes of each kernel call and
of a token's pass through the model, computed from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense bf16 without sparsity,
at the full 700 W. A call's bound is the larger of its operations at the
bf16 peak and its bytes at the HBM peak; each input byte counts once as
read and each output byte once as written.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12         # HBM3
POS_INVALID = np.iinfo(np.int32).max


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attended_pairs(sq: int, sk: int, *, seg_q=None, seg_k=None, pos_q=None,
                   pos_k=None, window: Optional[int] = None) -> int:
    """(query, key) pairs of one batch row that the flash kernel's mask
    lets through: causal by position (implicit positions are the indices,
    then sq == sk), the same segment where segment ids are given, keys at
    ``POS_INVALID`` never, and within ``window`` positions where set."""
    qp = np.arange(sq) if pos_q is None else np.asarray(pos_q, np.int64)
    kp = np.arange(sk) if pos_k is None else np.asarray(pos_k, np.int64)
    qs = np.zeros(sq, np.int64) if seg_q is None else np.asarray(seg_q,
                                                                 np.int64)
    ks = (qs if seg_k is None and sq == sk else np.zeros(sk, np.int64)) \
        if seg_k is None else np.asarray(seg_k, np.int64)
    ok = kp != POS_INVALID
    kp, ks = kp[ok], ks[ok]
    total = 0
    for s in np.unique(qs):
        kk = np.sort(kp[ks == s])
        qq = qp[qs == s]
        hi = np.searchsorted(kk, qq, side="right")
        lo = 0 if window is None else np.searchsorted(kk, qq - window + 1,
                                                      side="left")
        total += int(np.sum(hi - lo))
    return total


def flash_call(batch: int, sq: int, sk: int, heads: int, kv_heads: int,
               hd: int, pairs: int, elem: int = 2):
    """(flops, bytes) of one flash prefill call: QK^T and PV over the
    ``pairs`` the mask lets through (summed over the batch rows), q, k, v
    read and o written once."""
    flops = 4.0 * heads * hd * pairs
    nbytes = elem * hd * (2 * batch * sq * heads + 2 * batch * sk * kv_heads)
    return flops, nbytes


def decode_call(ctx_sum: int, rows: int, heads: int, kv_heads: int, hd: int,
                elem: int = 2):
    """(flops, bytes) of one paged decode call over rows whose contexts
    sum to ``ctx_sum``: the keys and values of each row's context read
    once, q read and o written once."""
    flops = 4.0 * heads * hd * ctx_sum
    nbytes = elem * hd * (2 * kv_heads * ctx_sum + 2 * rows * heads)
    return flops, nbytes


def matmul_params(cfg: dict) -> float:
    """Weights of the matrix products one token passes: every layer's
    q, k, v, o and feed-forward (a MoE's router and ``top_k`` experts) and
    the head; not the embedding lookup."""
    d, H, K, hd = cfg["d"], cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    attn = d * hd * (2 * H + 2 * K)
    ffn = 3 * d * cfg["d_ff"]
    if cfg["experts"]:
        ffn = ffn * cfg["top_k"] + d * cfg["experts"]
    return cfg["layers"] * (attn + ffn) + d * cfg["vocab"]


def model_flops(cfg: dict, tokens: int, ctx_sum: float) -> float:
    """Model FLOPs of ``tokens`` tokens whose attended contexts sum to
    ``ctx_sum``: 2 per matrix weight a token passes, plus QK^T and PV over
    its context in every layer."""
    return (2.0 * matmul_params(cfg) * tokens
            + 4.0 * cfg["layers"] * cfg["heads"] * cfg["head_dim"] * ctx_sum)


def step_share(cfg: dict, tokens: int, ctx_sum: float,
               seconds: float):
    """The model FLOPs of ``tokens`` tokens over the bf16 peak times
    ``seconds``, in %; None where nothing was processed."""
    if seconds <= 0 or not tokens:
        return None
    return 100.0 * model_flops(cfg, tokens, ctx_sum) / (PEAK_FLOPS
                                                         * seconds)
