"""Hand-written CUDA kernels for the serving hot spots (flash prefill
attention and paged decode attention), their plain PyTorch versions, and
the build that compiles them on first use."""
