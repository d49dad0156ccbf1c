"""Scheduler: 95th percentile of the wait from a request's arrival at the
scheduler to the start of its prompt's execution (``Request.t_start_exec -
Request.arrival`` of ``core/scheduler.py``), in ms, over the requests due
inside the window. One not started by the window's end counts at its age
then."""
import numpy as np


def read(s):
    core = s.counters.core
    waits = []
    for r in s.recs:
        c = core.get(r.rid)
        if c is None or not s.w0 <= r.due < s.w1:
            continue
        start = c.t_start_exec if c.t_start_exec is not None else s.w1
        waits.append(min(start, s.w1) - c.arrival)
    if not waits:
        return None
    return 1e3 * float(np.percentile(waits, 95))
