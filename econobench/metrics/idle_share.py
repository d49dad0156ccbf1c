"""Device: share of the traced slice in which no kernel or copy ran (the
union of their intervals against the slice's length), in %."""


def read(s):
    p = s.prof
    if p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
