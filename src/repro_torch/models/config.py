"""Model configuration for every architecture family the framework supports.

A single dataclass covers dense GQA transformers, MoE, Mamba2/SSM, xLSTM,
hybrid (Zamba2-style shared attention), and VLM/audio backbones whose
modality frontends are stubs (precomputed embeddings).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kind codes used in ``layer_pattern``:
#   'A' full attention block (attn + mlp)
#   'M' Mamba2 block
#   'S' sLSTM block
#   'X' mLSTM block
ATTN, MAMBA, SLSTM, MLSTM = "A", "M", "S", "X"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # ---- attention details -------------------------------------------------
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    attn_logit_softcap: Optional[float] = None

    # ---- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 2
    moe_d_ff: int = 0            # per-expert hidden size (0 -> d_ff)
    moe_dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01

    # ---- SSM (Mamba2) ------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256         # chunked SSD scan length

    # ---- xLSTM -------------------------------------------------------------
    xlstm_proj_factor: float = 2.0

    # ---- layer layout ------------------------------------------------------
    # If None: homogeneous stack of the arch_type's default block.
    # Otherwise a string over {A,M,S,X} of length num_layers.
    layer_pattern: Optional[str] = None
    # Zamba2-style: a single shared attention block applied every k-th layer
    # (weights shared across invocations). When set, layer_pattern covers the
    # non-shared layers only.
    shared_attention_every: int = 0
    shared_attn_kv_heads: int = 0  # kv heads for the shared block (0 -> num_kv_heads)

    # ---- modality frontend (stub) -------------------------------------------
    # 'vision' | 'audio' -> prefill accepts precomputed embeddings that are
    # prepended to the token embeddings.
    frontend: Optional[str] = None
    frontend_tokens: int = 0     # patches / audio-cond frames at prefill

    # ---- misc ----------------------------------------------------------------
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    # citation / provenance for the assigned-architecture pool
    source: str = ""

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def pattern(self) -> str:
        """Resolved per-layer kind string (excluding shared attention)."""
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.num_layers, (
                f"{self.name}: layer_pattern length {len(self.layer_pattern)} "
                f"!= num_layers {self.num_layers}")
            return self.layer_pattern
        if self.arch_type == "ssm":
            return MAMBA * self.num_layers
        return ATTN * self.num_layers

    def block_kinds(self) -> Tuple[str, ...]:
        """Unique layer kinds present, in first-appearance order."""
        seen = []
        for c in self.pattern():
            if c not in seen:
                seen.append(c)
        return tuple(seen)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return ATTN in self.pattern() or self.shared_attention_every > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic per-token decode state: SSM/hybrid or windowed attn."""
        if not self.has_attention:
            return True
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, *, layers: int = 2, d_model: int = 256,
                experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        heads = max(2, min(4, self.num_heads))
        kv = heads if self.num_kv_heads >= self.num_heads else max(1, heads // 2)
        d_model = max(d_model, heads * 32)
        pat = None
        if self.layer_pattern is not None:
            # keep the kind mix: take a slice that contains every kind
            kinds = self.block_kinds()
            pat = ("".join(kinds) * layers)[: layers]
            layers = len(pat)
        kw = dict(
            num_layers=layers, d_model=d_model, num_heads=heads,
            num_kv_heads=kv, head_dim=d_model // heads,
            d_ff=0 if self.d_ff == 0 else 4 * d_model,
            vocab_size=min(self.vocab_size, vocab),
            layer_pattern=pat,
            ssm_head_dim=32, ssm_state=min(self.ssm_state, 16) or 0,
            ssm_chunk=32,
            frontend_tokens=8 if self.frontend else 0,
            remat=False,
        )
        if self.is_moe:
            kw.update(num_experts=min(self.num_experts, experts),
                      moe_d_ff=2 * d_model)
        if self.shared_attention_every:
            kw.update(shared_attention_every=min(self.shared_attention_every, 2))
        if self.sliding_window:
            kw.update(sliding_window=64)
        return self.with_(**kw)
