"""Analytic roofline terms per (arch x shape) on NVIDIA H100 (SXM).

The reference's closed forms, unchanged: they are exact for the
matmul/attention/state math the model emits, and the dry-run traces no
device program to count. The dry-run's fake-tensor trace is the source of
the collective term (bytes counted per rank) and of memory-fit. Only the
per-card constants below differ from the reference's (TPU v5e there).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.costmodel import _param_count
from repro_torch.launch.shapes import LONG_WINDOW, SHAPES, ShapeSpec, adapt_config
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = 989e12   # bf16 dense FLOP/s, NVIDIA H100 SXM data sheet
HBM_BW = 3.35e12      # HBM3 bytes/s, the same data sheet
LINK_BW = 450e9       # NVLink 4 bytes/s a direction (900 GB/s both ways)
CHIPS = 256           # the production mesh: 32 nodes of 8 cards


def _attn_flops_prefill(cfg: ModelConfig, S: int, B: int) -> float:
    """Causal (windowed) attention matmul flops, forward, all layers."""
    pat = cfg.pattern()
    n_attn = pat.count("A")
    if cfg.shared_attention_every:
        n_attn += cfg.num_layers // cfg.shared_attention_every
    d_attn = cfg.num_heads * cfg.resolved_head_dim
    if cfg.sliding_window and cfg.sliding_window < S:
        w = cfg.sliding_window
        pairs = S * w - w * w / 2
    else:
        pairs = S * S / 2
    per_layer = 4.0 * d_attn * pairs          # qk + av, 2 flops each
    # mLSTM chunkwise decay-matrix work ~ chunk-local quadratic
    n_x = pat.count("X")
    if n_x:
        Q = cfg.ssm_chunk
        di = int(cfg.xlstm_proj_factor * cfg.d_model)
        per_layer_x = 4.0 * di * S * Q / 2
    else:
        per_layer_x = 0.0
    # Mamba2 chunked SSD: intra-chunk quadratic + state terms
    n_m = pat.count("M")
    if n_m:
        Q = cfg.ssm_chunk
        di, n = cfg.d_inner, cfg.ssm_state
        per_layer_m = S * (2.0 * di * Q + 6.0 * di * n)
    else:
        per_layer_m = 0.0
    return B * (n_attn * per_layer + n_x * per_layer_x + n_m * per_layer_m)


def _state_bytes_per_token(cfg: ModelConfig, ctx: int) -> float:
    """KV/state bytes read per decoded token (one request)."""
    pat = cfg.pattern()
    hd = cfg.resolved_head_dim
    n_attn = pat.count("A")
    kv = 0.0
    if n_attn:
        c = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        kv += n_attn * 2 * cfg.num_kv_heads * hd * 2 * c
    if cfg.shared_attention_every:
        n_inv = cfg.num_layers // cfg.shared_attention_every
        kvh = cfg.shared_attn_kv_heads or cfg.num_kv_heads
        kv += n_inv * 2 * kvh * hd * 2 * ctx
    if pat.count("M"):
        kv += pat.count("M") * cfg.ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state * 4 * 2                    # fp32 read+write
    if pat.count("X"):
        di = int(cfg.xlstm_proj_factor * cfg.d_model)
        hdx = di // cfg.num_heads
        kv += pat.count("X") * cfg.num_heads * hdx * hdx * 4 * 2
    if pat.count("S"):
        di = int(cfg.xlstm_proj_factor * cfg.d_model)
        kv += pat.count("S") * 4 * di * 4 * 2
    return kv


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "bottleneck": self.bottleneck}


def analytic_roofline(cfg: ModelConfig, shape: ShapeSpec, *,
                      collective_bytes_per_chip: float = 0.0,
                      chips: int = CHIPS) -> Roofline:
    cfg = adapt_config(cfg, shape)
    pc = _param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend_tokens if cfg.frontend else 0

    if shape.kind == "train":
        tokens = B * S
        # fwd + bwd + remat re-forward = 8 N D matmul flops
        flops = 8.0 * pc["compute"] * tokens \
            + 3.5 * _attn_flops_prefill(cfg, S, B)
        # weights streamed fwd/bwd/remat + AdamW state traffic
        wbytes = pc["compute"] * 2 * 3 + pc["total"] * (2 * 2 + 4 * 4)
        act = tokens * cfg.d_model * 2 * cfg.num_layers * 12
        logits = tokens * cfg.vocab_size * 2 * 3
        bytes_ = wbytes + act + logits
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * pc["compute"] * tokens \
            + _attn_flops_prefill(cfg, S, B)
        wbytes = pc["compute"] * 2
        act = tokens * cfg.d_model * 2 * cfg.num_layers * 6
        kv_write = B * _state_bytes_per_token(cfg, 1) / 2 * S
        bytes_ = wbytes + act + kv_write
    else:  # decode: one token per request against ctx
        flops = 2.0 * pc["compute"] * B \
            + 2.0 * B * _state_bytes_per_token(cfg, S) / 2
        bytes_ = pc["compute"] * 2 + B * _state_bytes_per_token(cfg, S)

    return Roofline(
        compute_s=flops / (chips * PEAK_FLOPS),
        memory_s=bytes_ / (chips * HBM_BW),
        collective_s=collective_bytes_per_chip / LINK_BW,
    )
