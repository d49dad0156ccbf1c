"""repro_torch: the EconoServe serving stack in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100. ``repro`` (JAX) is the reference it is
held against; this package imports nothing from it."""
__version__ = "0.1.0"
