"""Mistral-Nemo-12B: dense GQA, 128k context (long-context decode uses the
sliding-window attention variant). [hf:mistralai/Mistral-Nemo-Base-2407]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,          # Nemo uses head_dim 128 (< d_model/num_heads)
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
