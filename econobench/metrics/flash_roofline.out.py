"""``flash_roofline`` in the cells where it should move ``out_tok_s``."""
from econobench.metrics.flash_roofline import read  # noqa: F401
