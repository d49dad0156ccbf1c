"""Pure-attention GQA decoder in PyTorch: layouts mirror ``repro.models``."""
