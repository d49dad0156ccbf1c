"""Kernels: the paged decode kernel's share of its roofline over the
traced slice, in %: the sum of each call's bound (the keys and values
of every row's context, q and o, moved once at the HBM peak, or its
FLOPs at the bf16 peak, ``roofline.decode_call``) over the sum of the
kernel's device time."""
from econobench import roofline


def read(s):
    t = s.prof.kernel_s.get("decode", 0.0)
    if not s.calls.decode or t <= 0:
        return None
    return 100.0 * sum(roofline.bound_s(f, b) for f, b in s.calls.decode) / t
