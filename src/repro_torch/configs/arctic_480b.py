"""Snowflake Arctic 480B: dense-MoE hybrid — every layer has a dense
residual FFN in parallel with a 128-expert top-2 MoE.
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,             # dense residual FFN
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
    capacity_factor=1.25,
    rope_theta=10_000.0,
    source="hf:Snowflake/snowflake-arctic-base",
)
