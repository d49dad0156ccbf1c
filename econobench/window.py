"""Request-level metric arithmetic over one measured window [w0, w1).

Times are host seconds. A token's time is when the host first saw it in
the request's output. Definitions:

* ``out_tok_s``: output tokens seen inside the window / window seconds,
  over every request (begun before the window or unfinished at its end).
* ``ttft_p95_ms``: 95th percentile, over requests due inside the window,
  of first token seen - due time. A request with no token by w1 counts at
  its age then; a failed one as the largest value of the sample.
* ``tpot_p95_ms``: 95th percentile, over requests due inside the window
  with two tokens or more seen, of (last seen - first seen) / (tokens - 1).
* ``slo_attain``: share of requests whose deadline falls inside the window
  that completed by it; a failed request misses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Rec:
    due: float
    out: int                        # output tokens asked for
    deadline: float
    first: Optional[float] = None   # host time the first token was seen
    last: Optional[float] = None
    seen: int = 0                   # tokens seen so far
    done: Optional[float] = None    # host time the last asked token was seen
    failed: bool = False
    rid: int = -1                   # the engine's id of the request

    def observe(self, n: int, t: float) -> int:
        """The request shows ``n`` tokens at host time ``t``; returns how
        many are new."""
        new = n - self.seen
        if new <= 0:
            return 0
        if self.first is None:
            self.first = t
        self.last = t
        self.seen = n
        if n >= self.out and self.done is None:
            self.done = t
        return new


def p95(values) -> Optional[float]:
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def ttft_p95_ms(recs: List[Rec], w0: float, w1: float) -> Optional[float]:
    vals, failed = [], 0
    for r in recs:
        if not w0 <= r.due < w1:
            continue
        if r.failed:
            failed += 1
        elif r.first is not None and r.first <= w1:
            vals.append(r.first - r.due)
        else:
            vals.append(w1 - r.due)
    if failed:
        worst = max(vals + [w1 - w0])
        vals += [worst] * failed
    v = p95(vals)
    return None if v is None else 1e3 * v


def tpot_p95_ms(recs: List[Rec], w0: float, w1: float) -> Optional[float]:
    vals = [(r.last - r.first) / (r.seen - 1) for r in recs
            if w0 <= r.due < w1 and not r.failed and r.seen >= 2]
    v = p95(vals)
    return None if v is None else 1e3 * v


def slo_attain(recs: List[Rec], w0: float, w1: float) -> Optional[float]:
    due = [r for r in recs if w0 <= r.deadline < w1]
    if not due:
        return None
    met = sum(1 for r in due if not r.failed and r.done is not None
              and r.done <= r.deadline)
    return 100.0 * met / len(due)
