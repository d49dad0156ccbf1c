"""One run of one cell: weights and traffic from the seed, the port's
``ServingEngine`` driven on the host's monotonic clock through a pre-roll
and the measured window, the end-to-end or per-layer metrics, and the
comparison with the plain reference that decides ``correct``.

Everything that belongs to one cell, configuration, mix or per-layer
metric is a file found by name: ``cells/<cell>.json``,
``configs/<config>.json`` (named by ``BENCHMARK.json``),
``mixes/<mix>.json``, ``references/<reference>.py`` and
``metrics/<metric>.py``.

The window drives ``submit(req, now)`` at each request's due time (a
closed loop: when a client's previous request completes), ``step(now)``
while work remains, and reads each request's ``output`` after every step:
a token's time is when the host first sees it there.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from . import traffic, window
from .window import Rec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_CAPACITY = 64          # the throwaway engine that builds the kernels


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "econobench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``FORBIDDEN``, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------------------- #
# what a cell names
# --------------------------------------------------------------------------- #
PORT_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "rms_eps",
             "num_local_experts": "num_experts",
             "num_experts_per_tok": "experts_per_token",
             "sliding_window": "sliding_window"}


def port_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file, bf16: the
    published keys it knows (``PORT_KEYS``), then the file's ``port``
    settings, which name the port's own fields."""
    from repro_torch.models.config import ModelConfig
    kw = {PORT_KEYS[k]: v for k, v in conf.items() if k in PORT_KEYS}
    kw.update(conf.get("port", {}))
    kw.setdefault("arch_type", "moe" if kw.get("num_experts") else "dense")
    return ModelConfig(name=conf["name"], dtype="bfloat16",
                       param_dtype="bfloat16", source=conf["source"], **kw)


def ref_config(mcfg) -> dict:
    """The sizes the reference and the FLOP counts read; ``attn_layers``
    is how many paged decode launches one decode iteration makes."""
    from repro_torch.models import model
    return {"layers": mcfg.num_layers, "d": mcfg.d_model,
            "attn_layers": mcfg.pattern().count("A")
            + model.num_shared_invocations(mcfg),
            "heads": mcfg.num_heads, "kv_heads": mcfg.num_kv_heads,
            "head_dim": mcfg.resolved_head_dim, "d_ff": mcfg.d_ff,
            "vocab": mcfg.vocab_size, "rope_theta": mcfg.rope_theta,
            "eps": mcfg.rms_eps, "experts": mcfg.num_experts,
            "top_k": mcfg.experts_per_token}


@dataclass
class Cell:
    name: str
    spec: dict                   # cells/<name>.json
    workload: dict               # its BENCHMARK.json entry
    conf: dict                   # configs/<config>.json
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return Cell(name=name, spec=load_json(HERE / "cells" / f"{name}.json"),
                workload=wl, conf=load_json(root / centry["file"]),
                mix=traffic.load_mix(wl["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


# --------------------------------------------------------------------------- #
# the window
# --------------------------------------------------------------------------- #
@dataclass
class Counters:
    """Program counters read from outside during a traced run: each
    iteration's batch (``form_batch``'s plan) and the scheduler's request
    records (``on_arrival``). The step and token sums run over the window
    before the traced slice (the profiler slows the host inside it)."""
    all_iters: int = 0           # plans with decode rows, whole window
    all_rows: int = 0
    step_s: float = 0.0          # host seconds inside step, before the slice
    tokens: int = 0              # tokens those steps processed, and the sum
    ctx: int = 0                 # of the contexts they attend over
    last: tuple = (0, 0)         # the last plan: tokens, their contexts
    all_ctx: int = 0             # decode rows' contexts, whole window
    max_rows: int = 0
    core: Dict[int, object] = field(default_factory=dict)


def _count(sched, c: Counters, clock, w0: float, w1: float):
    """Wrap the scheduler's ``form_batch`` and ``on_arrival``."""
    form0, arrive0 = sched.form_batch, sched.on_arrival

    def form_batch(t):
        plan = form0(t)
        rows = len(plan.decode_reqs)
        if rows and w0 <= clock() < w1:
            c.all_iters += 1
            c.all_rows += rows
            c.all_ctx += sum(r.prompt_len + r.generated
                             for r in plan.decode_reqs)
            c.max_rows = max(c.max_rows, rows)
        pt = pctx = 0
        for r, n in plan.prompt_items:
            pt += n
            pctx += n * r.prompt_done + n * (n + 1) // 2
        c.last = (rows + pt, pctx + sum(r.prompt_len + r.generated
                                        for r in plan.decode_reqs))
        return plan

    def on_arrival(r, t):
        c.core[r.rid] = r
        return arrive0(r, t)

    sched.form_batch, sched.on_arrival = form_batch, on_arrival


@dataclass
class Served:
    recs: List[Rec]
    done: List[tuple]            # (prompt, output) of completed requests
    tokens_in_window: int
    attempted: int
    failed: int
    w0: float
    w1: float
    counters: Counters
    prof: Optional[object] = None
    calls: Optional[object] = None


def drive(eng, items, spec: dict, seconds: float, *, trace: bool,
          device) -> Served:
    """Serve ``items`` from now: a pre-roll of ``spec["preroll_s"]``, then
    the window of ``seconds``. Open loop: each item is submitted once due.
    Closed loop: ``spec["clients"]`` clients each submit their next item
    as soon as their last one completes."""
    import torch
    from repro_torch.serving import GenRequest, SamplingParams
    from . import trace as tr

    clock = time.monotonic
    t0 = clock()
    w0 = t0 + spec["preroll_s"]
    w1 = w0 + seconds
    counters = Counters()
    calls = tr.Calls() if trace else None
    undo = tr.record_calls(calls) if trace else None
    if trace:
        _count(eng.scheduler, counters, clock, w0, w1)
        # the slice: its start before the window's end, and its length
        sl0 = w1 - spec["trace_slice"][0]
        sl1 = sl0 + spec["trace_slice"][1]
    prof = None
    closed = spec["loop"] == "closed"
    live: Dict[int, tuple] = {}
    recs: List[Rec] = []
    done, seen_w, attempted, failed = [], 0, 0, 0
    nxt = 0

    def submit(now: float, due: float):
        nonlocal nxt, attempted
        it = items[nxt]
        nxt += 1
        g = GenRequest(prompt=it.prompt.tolist(),
                       params=SamplingParams(max_new_tokens=it.out),
                       deadline=due + it.slo)
        eng.submit(g, now)
        rec = Rec(due=due, out=it.out, deadline=due + it.slo, rid=g.rid)
        recs.append(rec)
        live[g.rid] = (g, rec, it)
        if w0 <= due < w1:
            attempted += 1

    def observe(now: float):
        nonlocal seen_w, failed
        ended = []
        for rid, (g, rec, it) in live.items():
            new = rec.observe(len(g.output), now)
            if w0 <= now < w1:
                seen_w += new
            if g.status is not None:
                ended.append(rid)
                if g.status != "completed":
                    rec.failed = True
                    failed += w0 <= rec.due < w1
                else:
                    done.append((it.prompt, list(g.output)))
        for rid in ended:
            del live[rid]
        return len(ended)

    def rf(name):
        return torch.profiler.record_function(name) if trace and calls.on \
            else contextlib.nullcontext()

    if closed:
        for _ in range(spec["clients"]):
            submit(t0, t0)
    while True:
        now = clock()
        if trace and prof is None and sl0 <= now < min(sl1, w1):
            prof = _start_profile(torch, device)
            calls.on = True
            slice_cm = torch.profiler.record_function(tr.SLICE_SPAN)
            slice_cm.__enter__()
            # the profiler's start takes its time: the slice is as long
            # as asked from when recording began
            sl1 = clock() + spec["trace_slice"][1]
        if trace and prof is not None and calls.on and now >= min(sl1, w1):
            _sync(torch, device)
            slice_cm.__exit__(None, None, None)
            calls.on = False
            prof.__exit__(None, None, None)
        if now >= w1:
            break
        if not closed:
            while nxt < len(items) and t0 + items[nxt].due <= now:
                submit(now, t0 + items[nxt].due)
        if eng.has_work():
            with rf(tr.STEP_SPAN):
                eng.step(now)
            after = clock()
            if trace and w0 <= now < sl0:
                n, cx = counters.last
                counters.step_s += after - now
                counters.tokens += n
                counters.ctx += cx
            n_end = observe(after)
            if closed:
                for _ in range(n_end):
                    submit(after, after)
        else:
            wake = w1 if closed or nxt >= len(items) else min(
                w1, t0 + items[nxt].due)
            if trace and prof is None:      # the slice opens on time
                wake = min(wake, max(sl0, now))
            elif trace and calls.on:        # and closes on time
                wake = min(wake, sl1)
            with rf(tr.WAIT_SPAN):
                time.sleep(max(0.0, wake - clock()))
    if not closed and nxt >= len(items):
        raise RuntimeError("the stream ran out before the window closed")
    if trace:
        undo()
        if prof is None or calls.on:
            raise RuntimeError("the traced slice did not close inside the "
                               "window")
    return Served(recs=recs, done=done, tokens_in_window=seen_w,
                  attempted=attempted, failed=failed, w0=w0, w1=w1,
                  counters=counters, prof=prof, calls=calls)


def _sync(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _start_profile(torch, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(torch, device)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


# --------------------------------------------------------------------------- #
# correctness
# --------------------------------------------------------------------------- #
def pick(done: List[tuple], n: int, seed: int) -> List[tuple]:
    """The completed request with the most output tokens, and n - 1 others
    drawn from the seed."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i][1]))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(seed + 7)
    others = rng.choice(rest, size=min(n - 1, len(rest)), replace=False) \
        if rest else []
    return [done[longest]] + [done[int(i)] for i in others]


def _forced(sample):
    """Each sampled request, (prompt, served tokens) or (prompt, served
    tokens, chosen tokens), as one sequence of ids (the prompt and the
    served tokens), the positions whose logits choose each token, and the
    tokens chosen there (the served ones where none are given)."""
    import torch
    seqs, rows, toks = [], [], []
    for req in sample:
        prompt, out = req[0], req[1]
        P = len(prompt)
        seqs.append(torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                                    dtype=torch.long))
        rows.append(torch.arange(P - 1, P - 1 + len(out)))
        toks.append(torch.as_tensor(req[-1], dtype=torch.long))
    return seqs, rows, toks


def control_sample(ref_mod, rcfg: dict, params, sample, mode: str = "fp8"):
    """The control in the program's place: each sampled request as
    (prompt, served tokens, the tokens that the reference computed under
    ``mode`` (fp8: the precision below bf16) puts first at each served
    token's position, after the same prompt and served tokens)."""
    seqs, rows, _ = _forced(sample)
    other = ref_mod.logits(rcfg, params, seqs, rows, mode=mode)
    return [(req[0], req[1], o.argmax(dim=-1).tolist())
            for req, o in zip(sample, other)]


def gaps(ref_mod, rcfg: dict, params, sample, *,
         witness: bool = False) -> Dict[str, float]:
    """How far the chosen tokens' logits lie below the reference's best,
    over every token of the sample (``_forced``): the widest gap
    (``gap``), the mean gap (``mean_gap``) and the share of tokens that
    are not the reference's best (``miss``). With ``witness``, the same of
    the tokens that the reference computed with bf16 operands puts first
    at the same positions (``witness_*``)."""
    import torch
    seqs, rows, toks = _forced(sample)
    ref = ref_mod.logits(rcfg, params, seqs, rows)
    best = [lg.max(dim=-1).values for lg in ref]

    def summary(chosen, pre=""):
        g = torch.cat([b - lg.gather(1, t.to(lg.device)[:, None])[:, 0]
                       for lg, b, t in zip(ref, best, chosen)]).double()
        return {pre + "gap": float(g.max()),
                pre + "mean_gap": float(g.mean()),
                pre + "miss": float((g > 0).double().mean())}
    res = {"tokens": sum(len(t) for t in toks), **summary(toks)}
    if witness:
        other = ref_mod.logits(rcfg, params, seqs, rows, mode="bf16")
        res.update(summary([o.argmax(dim=-1) for o in other], "witness_"))
    return res


# --------------------------------------------------------------------------- #
# one run
# --------------------------------------------------------------------------- #
def n_items(cell: Cell, seconds: float) -> int:
    """Requests in the stream: enough for the pre-roll and the window at
    the cell's rate (a closed loop: its clients, and as many again as its
    ``max_rate`` allows), and the same for every seed."""
    s = cell.spec
    span = s["preroll_s"] + seconds
    if s["loop"] == "closed":
        return s["clients"] + int(s["max_rate"] * span) + 64
    return int(1.5 * s["rate"] * span) + 64


def build(cell: Cell, seed: int, device, mcfg=None, params=None):
    """Weights from the seed (unless given), the timed engine, and a
    throwaway engine over the same weights that runs one short request
    first (the kernels are built and loaded before the pre-roll)."""
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine
    from .weights import make_params
    mcfg = mcfg or port_config(cell.conf)
    if params is None:
        params = make_params(mcfg, seed, device)
    warm = ServingEngine(mcfg, params, max_batch=2, capacity=WARM_CAPACITY,
                         seed=seed, device=device)
    warm.run([GenRequest(prompt=list(range(1, 17)),
                         params=SamplingParams(max_new_tokens=4))])
    del warm
    eng = ServingEngine(mcfg, params, max_batch=cell.spec["rows"],
                        capacity=cell.spec["capacity"], seed=seed,
                        device=device)
    return mcfg, params, eng


def serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
          mcfg=None, params=None):
    """Set-up, pre-roll and window. Returns (mcfg, params, engine,
    served)."""
    mcfg, params, eng = build(cell, seed, device, mcfg, params)
    items = traffic.stream(cell.mix, n_items(cell, seconds), seed,
                           capacity=cell.spec["capacity"],
                           vocab=mcfg.vocab_size,
                           rate=cell.spec.get("rate"))
    served = drive(eng, items, cell.spec, seconds, trace=trace,
                   device=device)
    return mcfg, params, eng, served


def end_to_end(cell: Cell, served: Served, setup_s: float) -> dict:
    w0, w1 = served.w0, served.w1
    val = {"setup_s": setup_s,
           "out_tok_s": served.tokens_in_window / (w1 - w0),
           "ttft_p95_ms": window.ttft_p95_ms(served.recs, w0, w1),
           "tpot_p95_ms": window.tpot_p95_ms(served.recs, w0, w1),
           "slo_attain": window.slo_attain(served.recs, w0, w1)}
    return {m["name"]: {"value": val[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if val.get(m["name"]) is not None}


def per_layer(cell: Cell, served: Served, mcfg):
    """The cell's per-layer metrics from the traced slice, and the slice's
    reading (``trace.Profile``)."""
    from . import trace as tr
    prof = tr.read(served.prof)
    s = SimpleNamespace(prof=prof, counters=served.counters,
                        calls=_resolve(served.calls, mcfg),
                        cfg=ref_config(mcfg), recs=served.recs,
                        w0=served.w0, w1=served.w1)
    out = {}
    for m in cell.per_layer:
        v = load_module(HERE / "metrics" / f"{m['name']}.py").read(s)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out, prof


def live(served: Served, mcfg) -> dict:
    """What the decode rows held over the window (a traced run): rows in
    use, their mean and largest number, and the bytes of the keys and
    values of their contexts, the mean over decode iterations."""
    c = served.counters
    if not c.all_iters:
        return {}
    per_token = (2 * mcfg.num_layers * mcfg.num_kv_heads
                 * mcfg.resolved_head_dim * 2)
    return {"decode_rows_mean": c.all_rows / c.all_iters,
            "decode_rows_max": c.max_rows,
            "kv_live_bytes_mean": per_token * c.all_ctx / c.all_iters}


def _resolve(calls, mcfg) -> SimpleNamespace:
    """The recorded kernel calls as (flops, bytes) pairs, their masks
    read back to the host once the slice has closed."""
    from . import roofline as rl

    def host(t):
        return None if t is None else t.detach().cpu().numpy()
    flash, decode = [], []
    memo = {}
    for qs, ks, seg, kseg, qpos, kpos, win in calls.flash:
        B, Sq, H, hd = qs
        Sk, K = ks[1], ks[2]
        arrs = [host(a) for a in (seg, kseg, qpos, kpos)]
        pairs = 0
        for b in range(B):
            row = [None if a is None else a.reshape(B, -1)[b] for a in arrs]
            key = (Sq, Sk, win) + tuple(
                None if a is None else a.tobytes() for a in row)
            if key not in memo:
                memo[key] = rl.attended_pairs(
                    Sq, Sk, seg_q=row[0], seg_k=row[1], pos_q=row[2],
                    pos_k=row[3], window=win)
            pairs += memo[key]
        flash.append(rl.flash_call(B, Sq, Sk, H, K, hd, pairs))
    for qs, cs, lens in calls.decode:
        B, H, hd = qs
        K = cs[2]
        decode.append(rl.decode_call(int(host(lens).sum()), B, H, K, hd))
    return SimpleNamespace(flash=flash, decode=decode)


def check(cell: Cell, mcfg, params, served: Served, seed: int):
    """The comparison that decides ``correct``: the cell's number (the
    widest gap, or where that has no upper reading the mean gap) over the
    sample's served tokens against the cell's limit, and every served token
    in the vocabulary. ``served.done`` holds the completed requests as
    (prompt, served tokens), or with the control in the program's place as
    ``control_sample`` gives them. Returns (correct, {name: {"value",
    "limit"}})."""
    ref = load_module(HERE / "references" / f"{cell.conf['reference']}.py")
    spec = cell.spec["check"]
    sample = pick(served.done, spec["requests"], seed)
    number, lim = spec["number"], spec["limit"]
    out = {"requests": {"value": len(sample), "limit": 1}}
    vocab_ok = all(0 <= t < mcfg.vocab_size for req in served.done
                   for t in req[-1])
    out["bad_tokens"] = {"value": 0 if vocab_ok else 1, "limit": 0}
    if sample:
        g = gaps(ref, ref_config(mcfg), params, sample)
        out["served_tokens"] = {"value": g["tokens"], "limit": 1}
        out[number] = {"value": g[number], "limit": lim}
    ok = (bool(sample) and vocab_ok and lim is not None
          and out[number]["value"] <= lim)
    return ok, out


def free(eng) -> None:
    """Drop the program's state (caches, slot state) before the reference
    runs: the weights stay."""
    import torch
    eng.caches = eng._dev = eng._pending_drain = None
    del eng
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
