"""``prefill_ms_per_call`` in the cells where it should move
``out_tok_s``."""
from econobench.metrics.prefill_ms_per_call import read  # noqa: F401
