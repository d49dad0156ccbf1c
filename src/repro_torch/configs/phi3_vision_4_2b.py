"""Phi-3-Vision 4.2B: phi3-mini text backbone + CLIP frontend (stub).

The vision encoder is a stub — ``input_specs`` supplies precomputed patch
embeddings of shape (B, frontend_tokens, d_model).
[hf:microsoft/Phi-3-vision-128k-instruct]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,       # MHA (GQA kv=32)
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    frontend_tokens=1024,  # ~ one 1024-patch image per request
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
