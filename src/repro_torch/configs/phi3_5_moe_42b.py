"""Phi-3.5-MoE 42B (6.6B active): 16-expert top-2 MoE transformer.
[hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    capacity_factor=1.25,
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
