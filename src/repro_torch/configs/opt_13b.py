"""OPT-13B-shaped dense model — the paper's own serving model (§2/§4).

We model it as a modern GQA-free (MHA) decoder with the OPT-13B dims;
used by the serving benchmarks and examples. [arXiv:2205.01068]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-13b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=20480,
    vocab_size=50272,
    rope_theta=10_000.0,
    source="arXiv:2205.01068",
)
