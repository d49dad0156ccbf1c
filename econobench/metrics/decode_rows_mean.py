"""Scheduler: active rows per decode iteration over the window, megastep
iterations included (each iteration's ``form_batch`` plan is one)."""


def read(s):
    c = s.counters
    return c.all_rows / c.all_iters if c.all_iters else None
