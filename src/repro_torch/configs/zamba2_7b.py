"""Zamba2-7B: Mamba2 backbone with a single shared attention block applied
every 6th layer (weights shared across invocations). [arXiv:2411.15242]
"""
from repro_torch.models.config import MAMBA, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,       # shared block is MHA
    head_dim=112,
    d_ff=14336,            # shared block MLP
    vocab_size=32000,
    layer_pattern=MAMBA * 81,
    shared_attention_every=6,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
)
