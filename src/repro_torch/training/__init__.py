"""Training in PyTorch, mirroring ``repro.training``: AdamW, the synthetic
data pipeline, the train step and loop, and msgpack checkpoints."""
