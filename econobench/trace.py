"""The traced slice: a ``torch.profiler`` trace of a fixed steady part of
the window, the program's ranges and kernel names read from it, and the
shapes of the attention kernels' calls recorded by wrapping the port's
wrappers from outside.

The port's ranges are ``engine.prefill_wave``, ``engine.prefill_chunks``,
``engine.decode`` (in ``ServingEngine.step``) and ``model.moe`` (nested
inside them). The harness adds ``bench.step`` around each ``step`` call,
``bench.wait`` around its sleeps and ``bench.slice`` around the slice.
A device kernel launched by an aten op belongs to the range in which the
op started on the host. The two attention kernels are launched through
ctypes, outside any op, and belong by name: flash to prefill, paged decode
to decode. The reading of the raw events follows ``chip_smoke.py``'s
``read_profile``.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFILL_SPANS = ("engine.prefill_wave", "engine.prefill_chunks")
DECODE_SPAN = "engine.decode"
MOE_SPAN = "model.moe"
STEP_SPAN, WAIT_SPAN, SLICE_SPAN = "bench.step", "bench.wait", "bench.slice"
SPANS = PREFILL_SPANS + (DECODE_SPAN,)
HOST_SPANS = SPANS + (MOE_SPAN, STEP_SPAN, WAIT_SPAN, SLICE_SPAN)
FLASH = re.compile(r"flash_\w*kernel")
DECODE = re.compile(r"paged_decode_\w*kernel")


@dataclass
class Calls:
    """Attention kernel calls made while the slice was traced, in launch
    order: the wrapper's arguments, kept as tensors and read once the
    slice has closed."""
    flash: List[tuple] = field(default_factory=list)
    decode: List[tuple] = field(default_factory=list)
    on: bool = False


def record_calls(calls: Calls):
    """Wrap the port's kernel entry points (``kernels.ops._flash`` and
    ``kernels.ops._decode_rows``) so that, while ``calls.on``, each call's
    shapes and mask tensors are kept. Returns an undo function."""
    from repro_torch.kernels import ops
    flash0, dec0 = ops._flash, ops._decode_rows

    def flash(q, k, v, **kw):
        if calls.on:
            calls.flash.append((tuple(q.shape), tuple(k.shape),
                                kw.get("segment_ids"),
                                kw.get("kv_segment_ids"),
                                kw.get("q_positions"),
                                kw.get("kv_positions"), kw.get("window")))
        return flash0(q, k, v, **kw)

    def decode(q, cache_k, cache_v, context_lens, page, **kw):
        if calls.on:
            calls.decode.append((tuple(q.shape), tuple(cache_k.shape),
                                 context_lens))
        return dec0(q, cache_k, cache_v, context_lens, page, **kw)

    ops._flash, ops._decode_rows = flash, decode

    def undo():
        ops._flash, ops._decode_rows = flash0, dec0
    return undo


@dataclass
class Profile:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # by group: flash, decode, other
    kernel_n: Dict[str, int]            # launches by group
    span_s: Dict[str, float]            # device seconds owned by each range
    span_launches: Dict[str, int]       # kernels launched inside each range
    span_calls: Dict[str, int]          # host ranges entered in the slice
    moe_decode_s: float                 # aten device time in model.moe
                                        # inside engine.decode
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _group(name: str) -> str:
    if FLASH.search(name):
        return "flash"
    if DECODE.search(name):
        return "decode"
    return "other"


def _inside(spans, starts, t) -> Optional[tuple]:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < spans[i][1]:
        return spans[i]
    return None


def read(prof) -> Profile:
    """One pass over the profiler's raw events."""
    from torch.autograd import DeviceType
    host: Dict[str, list] = defaultdict(list)
    op_start: Dict[int, int] = {}
    dev = []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CPU:
            name = e.name()
            if name in HOST_SPANS:
                host[name].append((e.start_ns(), e.end_ns(), name))
            elif e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
        elif kind == DeviceType.CUDA:
            name = e.name()
            if name in HOST_SPANS:
                continue     # a range's shadow on the device timeline
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), name,
                        e.linked_correlation_id()))
    (w0, w1, _), = host[SLICE_SPAN][:1] or [(0, 0, None)]
    phase = sorted(x for n in SPANS for x in host[n])
    phase_st = [x[0] for x in phase]
    moe = sorted(host[MOE_SPAN])
    moe_st = [x[0] for x in moe]
    kernel_s = defaultdict(float)
    kernel_n = defaultdict(int)
    span_s = dict.fromkeys(SPANS, 0.0)
    span_n = dict.fromkeys(SPANS, 0)
    by_name: Dict[str, float] = defaultdict(float)
    moe_dec = 0.0
    ivals = []
    for s, e, name, link in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        sec = (e - s) / 1e9
        ivals.append((s, e))
        g = _group(name)
        kernel_s[g] += sec
        kernel_n[g] += 1
        by_name[name] += sec
        if g == "flash":
            continue             # prefill's, by name (not a range's launch)
        if g == "decode":
            span_s[DECODE_SPAN] += sec
            span_n[DECODE_SPAN] += 1
            continue
        t = op_start.get(link)
        if t is None:
            continue
        sp = _inside(phase, phase_st, t)
        if sp is not None:
            span_s[sp[2]] += sec
            span_n[sp[2]] += 1
        if sp is not None and sp[2] == DECODE_SPAN \
                and _inside(moe, moe_st, t) is not None:
            moe_dec += sec
    busy, gaps = _union(ivals, w0, w1)
    return Profile(
        window_s=(w1 - w0) / 1e9, busy_s=busy,
        kernel_s=dict(kernel_s), kernel_n=dict(kernel_n), span_s=span_s,
        span_launches=span_n,
        span_calls={n: sum(1 for x in host[n] if w0 <= x[0] < w1)
                    for n in SPANS},
        moe_decode_s=moe_dec,
        top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=_gaps_by_host(gaps, host))


def _union(ivals, w0, w1):
    """Seconds covered by the intervals, and the gaps between them inside
    [w0, w1)."""
    ivals.sort()
    busy, gaps, cur = 0, [], w0
    for s, e in ivals:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < w1:
        gaps.append((cur, w1))
    return busy / 1e9, gaps


def _gaps_by_host(gaps, host) -> List[Tuple[str, float]]:
    """Idle device seconds by what the host was doing at each gap's middle:
    the innermost of the ranges open then (a phase, the MoE, the rest of
    ``step``, the harness's wait), else the harness outside ``step``."""
    order = (MOE_SPAN,) + SPANS + (STEP_SPAN, WAIT_SPAN)
    idx = {}
    for n in order:
        sp = sorted(host[n])
        idx[n] = (sp, [x[0] for x in sp])
    total: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        what = "harness outside step"
        for n in order:
            if _inside(*idx[n], mid) is not None:
                what = n if n != STEP_SPAN else "step outside the phases"
                break
        total[what] += (e - s) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])[:10]
