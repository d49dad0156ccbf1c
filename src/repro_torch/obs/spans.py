"""Host spans of the serving loop: named blocks whose host time a
``SpanTotals`` adds up and, for the four names in ``PROFILER_RANGES``,
ranges that ``torch.profiler`` records.

    totals = SpanTotals()
    engine.spans = totals          # the engine's own spans and, while it
    ...                            # steps, the kernel wrappers' ones
    before = totals.snapshot()
    ...
    SpanTotals.between(before, totals.snapshot())   # {"ns": .., "calls": ..}

``span(name, totals)`` enters a ``torch.profiler.record_function`` while a
profiler records and ``name`` is in ``PROFILER_RANGES``, and adds the
block's ``time.perf_counter_ns`` and one call to ``totals`` when it is
given. With neither, it enters a shared null context: one profiler flag
read and no clock read.

Only the four ranges that the benchmark's trace reader
(``econobench/trace.py``) skips by name reach the profiler: under a CUDA
profile every ``record_function`` range also leaves a shadow on the
device timeline, spanning the kernels launched inside it, and that reader
counts the shadow of any other range as a kernel.

Code without an engine at hand (the kernel wrappers, ``model.moe``) adds
to ``current()``, the totals of the engine that is stepping, which
``ServingEngine.step`` sets with ``set_current``.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

PROFILER_RANGES = frozenset({"engine.prefill_wave", "engine.prefill_chunks",
                             "engine.decode", "model.moe"})

_OFF = contextlib.nullcontext()
_current: Optional["SpanTotals"] = None


class SpanTotals:
    """Host nanoseconds and calls of each span name. ``unix_minus_mono_ns``
    is ``time.time_ns() - time.monotonic_ns()`` when the totals were made:
    a ``time.monotonic()`` stamp of the program (``GenRequest.t_submit``,
    ``t_first_sampled``, ``t_first_drained``) plus it, in nanoseconds, is
    on the clock of ``torch.profiler``'s events."""

    def __init__(self):
        self.ns: Dict[str, int] = defaultdict(int)
        self.calls: Dict[str, int] = defaultdict(int)
        self.unix_minus_mono_ns = time.time_ns() - time.monotonic_ns()

    def add(self, name: str, ns: int) -> None:
        self.ns[name] += ns
        self.calls[name] += 1

    def snapshot(self) -> dict:
        return {"ns": dict(self.ns), "calls": dict(self.calls)}

    @staticmethod
    def between(before: dict, after: dict) -> dict:
        """What was added from the snapshot ``before`` to ``after``."""
        return {k: {n: v - before[k].get(n, 0) for n, v in after[k].items()}
                for k in ("ns", "calls")}


class _Span:
    __slots__ = ("name", "totals", "rf", "t0")

    def __init__(self, name: str, totals: Optional[SpanTotals], rf):
        self.name, self.totals, self.rf = name, totals, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.totals is not None:
            self.totals.add(self.name, time.perf_counter_ns() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, totals: Optional[SpanTotals] = None):
    """A context manager for one block of host work (see the module)."""
    rf = None
    if _autograd_profiler._is_profiler_enabled and name in PROFILER_RANGES:
        rf = torch.profiler.record_function(name)
    elif totals is None:
        return _OFF
    return _Span(name, totals, rf)


def spanned(name: str):
    """Make each call of the decorated function the span ``name`` of
    ``current()``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, _current):
                return fn(*args, **kwargs)
        return call
    return wrap


def current() -> Optional[SpanTotals]:
    """The totals of the engine that is stepping (None: not collected)."""
    return _current


def set_current(totals: Optional[SpanTotals]) -> None:
    global _current
    _current = totals
