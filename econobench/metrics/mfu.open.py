"""Whole step: model FLOPs of the tokens processed in the window before
the traced slice (prefill tokens and decode rows, ``roofline.model_flops``)
over the bf16 peak times the host seconds spent inside ``step`` then, in
%. (The profiler slows the host inside the slice, so the slice is left
out.)"""
from econobench.roofline import step_share


def read(s):
    c = s.counters
    return step_share(s.cfg, c.tokens, c.ctx, c.step_s)
