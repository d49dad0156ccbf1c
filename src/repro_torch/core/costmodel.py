"""Analytic iteration cost model for the discrete-event simulator.

Roofline-style: an iteration processing P prompt tokens and a set of decode
tokens (one per running GT, each attending its context) costs

    t = t_fix + max(flops / peak_flops, bytes / hbm_bw)

with weight bytes counted once per iteration (they are streamed for any
batch) and KV bytes per decode token proportional to its context. This
reproduces the qualitative regimes the paper relies on: prefill is
compute-bound, decode is memory-bound, and batching decode tokens amortizes
the weight stream (why TFS matters).

Two hardware profiles ship: the paper's A100-80GB, and TPU v5e (the
deployment target of this framework).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # FLOP/s (bf16)
    hbm_bw: float              # bytes/s
    swap_bw: float             # device<->host bytes/s (PCIe / PCIe-like)
    link_bw: float             # inter-device bytes/s (for KV transfer)
    t_fix: float = 8e-4        # per-iteration fixed overhead (s)


# swap_bw is the *effective* KV swap bandwidth, not raw PCIe: paged KV lives
# in non-contiguous blocks, and the vLLM-0.2-era swap path the paper measures
# does synchronous per-block copies (fig 1e: preemption = 20% of vLLM's JCT).
A100 = Hardware("a100", peak_flops=312e12, hbm_bw=2.0e12,
                swap_bw=2.5e9, link_bw=12.5e9)       # 100 Gb/s Ethernet
TPU_V5E = Hardware("tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                   swap_bw=2.0e9, link_bw=50e9)


@dataclass(frozen=True)
class ModelProfile:
    """What the cost model needs to know about the served model."""
    name: str
    n_params: float            # total parameters
    n_active: float            # active per token (MoE)
    n_layers: int
    kv_bytes_per_token: int    # across all layers
    d_model: int

    @staticmethod
    def from_config(cfg) -> "ModelProfile":
        hd = cfg.resolved_head_dim
        kvb = cfg.num_layers * 2 * cfg.num_kv_heads * hd * 2  # bf16
        n = _param_count(cfg)
        return ModelProfile(cfg.name, n_params=n["total"],
                            n_active=n["active"], n_layers=cfg.num_layers,
                            kv_bytes_per_token=kvb, d_model=cfg.d_model)


def _param_count(cfg) -> dict:
    """Storage ('total'), per-token-active ('active'), and per-token
    *compute* ('compute': counts shared-attention blocks once per
    invocation) parameter counts, covering every block kind."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    dense_mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0
    moe = moe_active = 0
    if cfg.is_moe:
        ff = cfg.moe_d_ff or cfg.d_ff
        moe = cfg.num_experts * 3 * d * ff
        moe_active = cfg.experts_per_token * 3 * d * ff

    pattern = cfg.pattern()
    per_kind = {}
    if "A" in pattern:
        mlp_part = (moe + dense_mlp) if cfg.is_moe else dense_mlp
        mlp_act = (moe_active + dense_mlp) if cfg.is_moe else dense_mlp
        per_kind["A"] = (attn + mlp_part, attn + mlp_act)
    if "M" in pattern:
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        m = d * (2 * di + 2 * n + nh) + di * d \
            + cfg.ssm_conv_width * (di + 2 * n)
        per_kind["M"] = (m, m)
    if "X" in pattern or "S" in pattern:
        di = int(cfg.xlstm_proj_factor * d)
        x_p = 4 * d * di + di * d                      # q,k,v,o + down
        s_p = 4 * d * di + di * d + cfg.num_heads \
            * (di // cfg.num_heads) * 4 * (di // cfg.num_heads)
        per_kind["X"] = (x_p, x_p)
        per_kind["S"] = (s_p, s_p)

    total = active = 0
    for ch in pattern:
        t, a = per_kind[ch]
        total += t
        active += a
    # Zamba2-style shared attention: stored once, computed every invocation
    compute = active
    if cfg.shared_attention_every:
        kvh = cfg.shared_attn_kv_heads or cfg.num_kv_heads
        shared = d * hd * (cfg.num_heads * 2 + kvh * 2) + 3 * d * cfg.d_ff
        n_inv = cfg.num_layers // cfg.shared_attention_every
        total += shared
        active += shared
        compute += shared * n_inv
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total += embed
    active += embed
    compute += embed
    return {"total": float(total), "active": float(active),
            "compute": float(compute)}


# OPT-13B profile used throughout the paper's experiments
OPT_13B = ModelProfile("opt-13b", n_params=13e9, n_active=13e9, n_layers=40,
                       kv_bytes_per_token=40 * 2 * 40 * 128 * 2, d_model=5120)


@dataclass
class CostModel:
    hw: Hardware = A100
    model: ModelProfile = OPT_13B
    weight_dtype_bytes: int = 2

    # ------------------------------------------------------------------ #
    def iteration_time(self, prompt_tokens: int,
                       decode_contexts: Iterable[int]) -> float:
        ctxs = list(decode_contexts)
        tokens = prompt_tokens + len(ctxs)
        if tokens == 0:
            return 0.0
        flops = 2.0 * self.model.n_active * tokens
        # attention flops (quadratic prefill term is folded into per-token
        # context costs upstream; decode attention flops are tiny vs matmuls)
        weight_bytes = self.model.n_active * self.weight_dtype_bytes
        kv_bytes = self.model.kv_bytes_per_token * float(sum(ctxs))
        act_bytes = tokens * self.model.d_model * 2 * self.model.n_layers * 4
        t_compute = flops / self.hw.peak_flops
        t_mem = (weight_bytes + kv_bytes + act_bytes) / self.hw.hbm_bw
        return self.hw.t_fix + max(t_compute, t_mem)

    def prompt_time(self, prompt_len: int) -> float:
        return self.iteration_time(prompt_len, [])

    def token_time(self, context: int = 512) -> float:
        return self.iteration_time(0, [context])

    # ------------------------------------------------------------------ #
    def swap_time(self, tokens: int) -> float:
        """Offload (or restore) `tokens` of KV to/from host memory."""
        return tokens * self.model.kv_bytes_per_token / self.hw.swap_bw

    def swap_out_time(self, tokens: int) -> float:
        """Device→host leg only. The tiered ladder charges each direction
        where it happens (out at swap-out, in at swap-in) instead of the
        legacy 2x round-trip charged up front."""
        return self.swap_time(tokens)

    def swap_in_time(self, tokens: int) -> float:
        """Host→device leg only (restore of a host-offloaded image)."""
        return self.swap_time(tokens)

    def kv_transfer_time(self, tokens: int) -> float:
        """DistServe-style prefill→decode instance KV handoff."""
        return tokens * self.model.kv_bytes_per_token / self.hw.link_bw

    def recompute_time(self, tokens: int) -> float:
        """Offload-free preemption restore = re-prefill of prompt+generated."""
        return self.iteration_time(tokens, [])

    # ------------------------------------------------------------------ #
    # scheduling-time models (per batch formation), §2.2 / Figure 14
    def sched_time_fcfs(self, n_queued: int, n_selected: int) -> float:
        return 2e-5 + 1e-6 * n_selected

    def sched_time_quadratic(self, n_queued: int, n_selected: int) -> float:
        """MultiRes: O(n^2) Euclidean-distance matching."""
        return 2e-5 + 2.5e-7 * n_queued * max(1, n_selected)

    def sched_time_grouped(self, n_queued: int, n_selected: int) -> float:
        """EconoServe: priority queues + binary search."""
        import math
        return 3e-5 + 2e-6 * n_selected * max(1.0, math.log2(max(2, n_queued)))

    def sched_time_mlfq(self, n_queued: int, n_selected: int) -> float:
        """FastServe: multi-level feedback queue with demotions."""
        return 2e-5 + 6e-6 * n_queued


def tfs_for(hw: Hardware, model: ModelProfile,
            dtype_bytes: int = 2) -> int:
    """Target forward size: tokens where compute time overtakes the weight
    stream (MXU/SM saturation point), as FastGen/Sarathi pick it."""
    t_weights = model.n_active * dtype_bytes / hw.hbm_bw
    per_token_flop_time = 2.0 * model.n_active / hw.peak_flops
    tokens = t_weights / per_token_flop_time  # = peak_flops*bytes/(2*bw)
    # round up to a multiple of 64 for hardware alignment
    return int(-(-tokens // 64) * 64)
