"""Kernels: the flash prefill kernel's share of its roofline over the
traced slice, in %: the sum of each call's bound (the larger of the
unmasked pairs' FLOPs at the bf16 peak and q, k, v, o moved once at the
HBM peak, ``roofline.flash_call``) over the sum of the kernel's device
time."""
from econobench import roofline


def read(s):
    t = s.prof.kernel_s.get("flash", 0.0)
    if not s.calls.flash or t <= 0:
        return None
    return 100.0 * sum(roofline.bound_s(f, b) for f, b in s.calls.flash) / t
