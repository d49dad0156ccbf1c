"""Card smoke test of the PyTorch port: build, check and time the CUDA
kernels, then serve qwen3-8b at full width through ``ServingEngine``.

    python3 chip_smoke.py [--seed N]      # one GPU

Phases (any failure raises and exits non-zero):
  1. card: require CUDA, print the name and power limit (nvidia-smi);
  2. build both kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a),
     print build seconds and ptxas registers / shared memory;
  3. each kernel against its plain PyTorch version on the card, float32
     (TF32 off, tol 1e-4) and bfloat16 (one bf16 ulp, see ``TOL``), at the
     test sweeps and at the serving path's shapes (packed prefill, a chunk
     over a cache row, a packed chunk wave, decode); time kernel, plain
     version and one library call (SDPA) with CUDA events, and compute each
     kernel's bound;
  4. the main path: qwen3-8b at its published widths and depth (36 layers,
     bf16, seeded random weights), max_batch 8, capacity 2048, default
     EngineConfig, 12 requests; checks lengths, launch counters, chunk waves
     and megastep windows; prints tokens/s of the unsynchronised run, then
     serves the same workload under ``torch.profiler`` for the device time
     per prefill call and per decode iteration and the idle share;
  5. greedy parity: full width cut to 4 layers, float32, TF32 off: the
     engine's greedy streams equal an isolated prefill + decode_step loop.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# (atol, rtol). The kernels and their plain versions both accumulate in
# float32 (TF32 off); in bfloat16 each rounds its float32 result once, so
# the two may differ by one bf16 ulp of the output: 2**-7 relative, and
# 1e-3 absolute for outputs near zero.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}
SPANS = ("engine.prefill_wave", "engine.prefill_chunks", "engine.decode")


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# phase 1-2: card and build
# --------------------------------------------------------------------------- #
def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    info = build.build_all()
    log(f"[2 build] {time.monotonic() - t0:.2f}s wall (both nvcc in parallel)")
    for name, rec in info.items():
        usage = re.findall(r"Used \d+ registers.*", rec["ptxas"])
        log(f"[2 build] {name}: {rec['seconds']:.2f}s nvcc")
        for fn, u in zip(re.findall(r"Compiling entry function '(\w+)'",
                                    rec["ptxas"]), usage):
            log(f"[2 build]   {fn}: {u}")


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def _time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _check(torch, name, got, want, dtype_name, errs) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol, rtol = TOL[dtype_name]
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    log(f"[3 kernels] {name} {dtype_name}: max_abs_err {err:.3e} "
        f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name} {dtype_name} disagrees with its plain "
                             f"version: max_abs_err {err}")
    errs.append(err)
    return err


def _flash_cases(torch, dtype, gen):
    """Yield (label, q, k, v, kwargs) over the test sweeps, in all modes."""
    from repro_torch.kernels.ref import POS_INVALID
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for B, S, H, K, hd, win, cap in [(2, 256, 4, 2, 64, None, None),
                                     (1, 200, 8, 8, 128, None, None),
                                     (2, 384, 4, 1, 64, 128, None),
                                     (1, 256, 2, 2, 64, None, 30.0),
                                     (1, 130, 6, 3, 32, 64, None)]:
        yield (f"implicit B{B} S{S} H{H} K{K} hd{hd} win{win} cap{cap}",
               rnd(B, S, H, hd), rnd(B, S, K, hd), rnd(B, S, K, hd),
               dict(window=win, softcap=cap))
    for seg_lens, win, cap in [((48, 80), None, None),
                               ((17, 60, 51), None, 30.0),
                               ((100, 28), 32, None),
                               ((5, 3, 90, 30), None, None)]:
        S = sum(seg_lens)
        seg = torch.repeat_interleave(
            torch.arange(len(seg_lens), device=dev),
            torch.tensor(seg_lens, device=dev))[None].int()
        yield (f"segments {seg_lens} win{win} cap{cap}", rnd(1, S, 4, 32),
               rnd(1, S, 2, 32), rnd(1, S, 2, 32),
               dict(window=win, softcap=cap, segment_ids=seg))
    for C, S, plen, win, cap in [(64, 48, 40, None, None),
                                 (96, 17, 60, None, 30.0),
                                 (128, 33, 100, 48, None),
                                 (64, 48, 0, None, None)]:
        slot = torch.arange(C, device=dev)
        qpos = (plen + torch.arange(S, device=dev))[None].expand(2, S)
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S, device=dev)])[None]
        yield (f"positions C{C} S{S} plen{plen} win{win} cap{cap}",
               rnd(2, S, 4, 32), rnd(2, C + S, 2, 32), rnd(2, C + S, 2, 32),
               dict(window=win, softcap=cap, q_positions=qpos.int(),
                    kv_positions=kpos.expand(2, C + S).int()))
    for Cp, spans, win, cap in [(64, ((40, 24), (0, 30)), None, None),
                                (64, ((60, 17), (32, 33), (5, 8)), None, 30.0),
                                (96, ((90, 20), (48, 40)), 64, None)]:
        n = len(spans)
        T = sum(L for _, L in spans)
        qpos, qseg, ppos, pseg = [], [], [], []
        for i, (start, L) in enumerate(spans):
            qpos.append(start + torch.arange(L))
            qseg.append(torch.full((L,), i))
            slot = torch.arange(Cp)
            ppos.append(torch.where(slot < start, slot, POS_INVALID))
            pseg.append(torch.full((Cp,), i))
        qpos, qseg = torch.cat(qpos)[None], torch.cat(qseg)[None]
        kpos = torch.cat(ppos + [qpos[0]])[None]
        kseg = torch.cat(pseg + [qseg[0]])[None]
        yield (f"packed-chunks Cp{Cp} spans{spans} win{win} cap{cap}",
               rnd(1, T, 4, 32), rnd(1, n * Cp + T, 2, 32),
               rnd(1, n * Cp + T, 2, 32),
               dict(window=win, softcap=cap, segment_ids=qseg.int().to(dev),
                    kv_segment_ids=kseg.int().to(dev),
                    q_positions=qpos.int().to(dev),
                    kv_positions=kpos.int().to(dev)))


def _main_segments(torch, T: int, n: int, gen):
    """Ragged segment lengths summing to T, drawn from ``gen``."""
    cuts = torch.randperm(T - 1, generator=gen)[:n - 1].add(1).sort().values
    edges = [0] + cuts.tolist() + [T]
    return [b - a for a, b in zip(edges, edges[1:])]


def _main_chunk_cases(torch, gen, C: int = 2048, H: int = 32, K: int = 8,
                      hd: int = 128):
    """The main path's chunk calls (bf16 inputs; the prefix slots hold
    random data, which the masks must hide), with masks built by
    ``chunk_kv_masks`` and ``packed_chunk_layout`` as ``attn_prefill`` and
    the engine build them: one chunk over a whole cache row of C slots,
    valid below its start, and a packed wave of three chunks over prefix
    views of Cp slots (one of them a prompt's first chunk)."""
    from repro_torch.models.attention import chunk_kv_masks
    from repro_torch.serving.engine import packed_chunk_layout

    def rnd(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    def dev(a):
        return torch.from_numpy(a).cuda()

    start, S = 1024, 512
    qpos = (start + torch.arange(S, dtype=torch.int32, device="cuda"))[None]
    kpos, _ = chunk_kv_masks(1, C, qpos, prefix_len=start)
    yield (f"chunk q (1,{S},{H},{hd}) start {start} k/v (1,{C + S},{K},"
           f"{hd})", (rnd(1, S, H, hd), rnd(1, C + S, K, hd),
                      rnd(1, C + S, K, hd),
                      dict(q_positions=qpos, kv_positions=kpos)))
    starts, lens = (1792, 640, 0), (256, 384, 512)
    pos, seg, ppos, pseg, _ = packed_chunk_layout(starts, lens, C)
    pos, seg = dev(pos), dev(seg)
    kpos, kseg = chunk_kv_masks(1, ppos.shape[1], pos, seg,
                                prefix_positions=dev(ppos),
                                prefix_segment_ids=dev(pseg))
    T, Sk = sum(lens), kpos.shape[1]
    yield (f"chunk wave starts {starts} lens {lens} q (1,{T},{H},{hd}) "
           f"k/v (1,{Sk},{K},{hd})",
           (rnd(1, T, H, hd), rnd(1, Sk, K, hd), rnd(1, Sk, K, hd),
            dict(segment_ids=seg, kv_segment_ids=kseg, q_positions=pos,
                 kv_positions=kpos)))


def phase_kernels(torch, seed: int) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cpu_gen = torch.Generator().manual_seed(seed)
    flash_errs, paged_errs = [], []
    for dtype, dn in ((torch.float32, "float32"),
                      (torch.bfloat16, "bfloat16")):
        for label, q, k, v, kw in _flash_cases(torch, dtype, gen):
            _check(torch, f"flash {label}", flash_attention(q, k, v, **kw),
                   ref.flash_attention(q, k, v, **kw), dn, flash_errs)
        for B, H, K, hd, page, MP in [(3, 8, 2, 64, 16, 5),
                                      (2, 4, 4, 128, 32, 4),
                                      (1, 8, 1, 64, 8, 7),
                                      (4, 2, 2, 32, 16, 3),
                                      (8, 32, 8, 128, 128, 16)]:
            P = B * MP + 3
            q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
            kp = torch.randn(P, page, K, hd, generator=gen,
                             device="cuda").to(dtype)
            vp = torch.randn(P, page, K, hd, generator=gen,
                             device="cuda").to(dtype)
            bt = torch.randperm(P, generator=cpu_gen)[:B * MP].reshape(
                B, MP).int().cuda()
            # ctx of 1, a page boundary, a page boundary + 1, and full
            choices = [1, page, page + 1, MP * page]
            cl = torch.tensor([choices[i % 4] for i in range(B)],
                              dtype=torch.int32, device="cuda")
            _check(torch, f"paged B{B} H{H} K{K} hd{hd} page{page} MP{MP} "
                          f"ctx{cl.tolist()}",
                   paged_decode_attention(q, kp, vp, bt, cl),
                   ref.paged_decode_attention(q, kp, vp, bt, cl), dn,
                   paged_errs)

    # ---- the serving path's shapes, bf16: check, time, bound ------------
    dt = torch.bfloat16
    T, H, K, hd = 2048, 32, 8, 128
    lens = _main_segments(torch, T, 8, cpu_gen)
    seg = torch.repeat_interleave(torch.arange(8),
                                  torch.tensor(lens))[None].int().cuda()
    q = torch.randn(1, T, H, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(1, T, K, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(1, T, K, hd, generator=gen, device="cuda").to(dt)
    for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
        qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
        _check(torch, f"flash main-path (1,{T},{H},{hd}) segments {lens}",
               flash_attention(qq, kk, vv, segment_ids=seg),
               ref.flash_attention(qq, kk, vv, segment_ids=seg), dn,
               flash_errs)
    flash_err_main = flash_errs[-1]
    idx = torch.arange(T, device="cuda")
    mask = ((idx[None, :] <= idx[:, None])
            & (seg[0][:, None] == seg[0][None, :]))[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fl = {
        "ms": _time_ms(torch, lambda: flash_attention(q, k, v,
                                                      segment_ids=seg)),
        "plain_ms": _time_ms(torch, lambda: ref.flash_attention(
            q, k, v, segment_ids=seg), iters=5),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
    }
    pairs = sum(L * (L + 1) // 2 for L in lens)
    fl_flops = 4.0 * pairs * H * hd
    fl_bytes = 2.0 * (q.numel() * 2 + k.numel() + v.numel()) + 4.0 * T * 2
    fl.update(_bound(fl_flops, fl_bytes, "bfloat16"))
    for label, (q_, k_, v_, kw) in _main_chunk_cases(torch, gen):
        for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
            qq, kk, vv = q_.to(dtype), k_.to(dtype), v_.to(dtype)
            _check(torch, f"flash main-path {label}",
                   flash_attention(qq, kk, vv, **kw),
                   ref.flash_attention(qq, kk, vv, **kw), dn, flash_errs)
        log(f"[3 kernels] flash main-path {label} bf16 timing: kernel "
            f"{_time_ms(torch, lambda: flash_attention(q_, k_, v_, **kw)):.4f}"
            f" ms")

    B, C = 8, 2048
    ck = torch.randn(B, C, K, hd, generator=gen, device="cuda").to(dt)
    cv = torch.randn(B, C, K, hd, generator=gen, device="cuda").to(dt)
    qd = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    ctx = torch.randint(1, C + 1, (B,), generator=cpu_gen).int().cuda()
    ctx[0], ctx[1] = 1, C
    mp = C // ops.page_size(C)
    bt = (torch.arange(B)[:, None] * mp + torch.arange(mp)[None]).int().cuda()
    ps = ops.page_size(C)
    for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
        a, b_, c_ = qd.to(dtype), ck.to(dtype), cv.to(dtype)
        _check(torch, f"decode_attention ({B},{C},{K},{hd}) "
                      f"ctx {ctx.tolist()}",
               ops.decode_attention(a, b_, c_, ctx),
               ref.paged_decode_attention(
                   a, b_.reshape(B * mp, ps, K, hd),
                   c_.reshape(B * mp, ps, K, hd), bt, ctx), dn, paged_errs)
    paged_err_main = paged_errs[-1]
    kp, vp = ck.reshape(B * mp, ps, K, hd), cv.reshape(B * mp, ps, K, hd)
    dmask = (torch.arange(C, device="cuda")[None] < ctx[:, None].long())
    dq, dk, dv = qd[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    pg = {
        "ms": _time_ms(torch, lambda: paged_decode_attention(
            qd, kp, vp, bt, ctx), iters=50),
        "plain_ms": _time_ms(torch, lambda: ref.paged_decode_attention(
            qd, kp, vp, bt, ctx)),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            dq, dk, dv, attn_mask=dmask[:, None, None], enable_gqa=True),
            iters=50),
    }
    toks = int(ctx.sum())
    pg_flops = 4.0 * toks * H * hd
    pg_bytes = 2.0 * (2 * toks * K * hd + 2 * qd.numel()) + 4.0 * B * (mp + 1)
    pg.update(_bound(pg_flops, pg_bytes, "bfloat16"))
    for name, rec in (("flash_prefill", fl), ("paged_decode", pg)):
        log(f"[3 kernels] {name} main-path timing: kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f}"
            f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return {
        "flash_prefill": dict(fl, max_abs_err=flash_err_main,
                              max_abs_err_all=max(flash_errs)),
        "paged_decode": dict(pg, max_abs_err=paged_err_main,
                             max_abs_err_all=max(paged_errs)),
    }


def _bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# --------------------------------------------------------------------------- #
# phase 4: the main path at full width
# --------------------------------------------------------------------------- #
def _workload(cfg, seed: int, n: int = 12):
    import numpy as np
    from repro_torch.serving import GenRequest, SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        hot = i in (3, 8)
        reqs.append(GenRequest(
            prompt=[int(t) for t in rng.integers(
                0, cfg.vocab_size, int(rng.integers(128, 1537)))],
            params=SamplingParams(
                max_new_tokens=int(rng.integers(32, 65)),
                temperature=0.8 if hot else 0.0, top_k=50 if hot else 0)))
    return reqs


def phase_main_path(torch, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.serving import ServingEngine

    cfg = get_config("qwen3_8b")
    L = cfg.num_layers
    t0 = time.monotonic()
    eng = ServingEngine(cfg, max_batch=8, capacity=2048, seed=seed,
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eng.params.values())
    log(f"[4 main] qwen3-8b full width: {L} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
        f"init {time.monotonic() - t0:.1f}s")
    reqs = _workload(cfg, seed)
    # warm the allocator and the kernels' libraries with one short request
    # on a throwaway engine sharing the weights, then count from zero
    from repro_torch.serving import GenRequest, SamplingParams
    warm = ServingEngine(cfg, eng.params, max_batch=8, capacity=2048,
                         seed=seed, device="cuda")
    warm.run([GenRequest(prompt=list(range(1, 65)),
                         params=SamplingParams(max_new_tokens=4))])
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.monotonic()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_prefill": flash_attention.launches,
                "paged_decode": paged_decode_attention.launches}

    for g in reqs:
        if g.t_done is None or len(g.output) != g.params.max_new_tokens:
            raise AssertionError(f"request {g.rid} incomplete: "
                                 f"{len(g.output)}/{g.params.max_new_tokens}")
        if not all(0 <= t < cfg.vocab_size for t in g.output):
            raise AssertionError(f"request {g.rid}: token out of vocab")
    for hot in (reqs[3], reqs[8]):
        assert hot.params.temperature > 0
    for name, n in launches.items():
        if n <= 0 or n % L:
            raise AssertionError(f"{name}: {n} launches, not a positive "
                                 f"multiple of {L}")
    if eng.n_chunk_calls <= 0:
        raise AssertionError("no chunk wave ran on the main path")
    if eng.n_mega_windows <= 0:
        raise AssertionError("no megastep window ran on the main path")
    toks = sum(len(g.output) for g in reqs)
    res = {
        "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
        "decode_iters": eng.decode_iters,
        "decode_dispatches": eng.n_decode_dispatches,
        "mega_windows": eng.n_mega_windows,
        "prefill_waves": eng.n_prefill_waves,
        "chunk_calls": eng.n_chunk_calls,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sync_counts": dict(eng.sync_counts),
        "launches": launches,
    }
    log(f"[4 main] {json.dumps(res)}")
    params = eng.params
    del eng
    res["profile"] = phase_profile(torch, cfg, params, seed, wall)
    return res


def phase_profile(torch, cfg, params, seed: int, wall: float) -> dict:
    """Where the time goes: the phase-4 workload again, on a fresh engine
    with the same weights and seed, under ``torch.profiler``.

    The profiler ties a kernel that aten launches to the op, and so to the
    engine's range (``SPANS``), that launched it, but a kernel launched
    through ctypes to no op at all. So a phase's device time is that of the
    aten kernels inside its ranges plus its attention kernel, taken by name
    (flash: prefill waves and chunk calls; paged decode: decode). The idle
    share is 1 - (device kernel time / wall time of the unprofiled run of
    the same workload)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, max_batch=8, capacity=2048, seed=seed,
                        device="cuda")
    reqs = _workload(cfg, seed)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    wall_prof = time.monotonic() - t0
    groups = {"flash_prefill": 0.0, "paged_decode": 0.0, "gemm": 0.0,
              "other": 0.0}
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key in SPANS:
            continue                  # host rows and the ranges' own spans
        us = float(ev.self_device_time_total)
        rows.append((us, ev.count, ev.key))
        name = ev.key.lower()
        key = ("flash_prefill" if "flash_prefill" in name else
               "paged_decode" if "paged_decode" in name else
               "gemm" if any(t in name for t in ("gemm", "nvjet", "xmma",
                                                 "cutlass")) else "other")
        groups[key] += us
    span_us = dict.fromkeys(SPANS, 0.0)
    span_host_us = dict.fromkeys(SPANS, 0.0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.key in SPANS:
            span_us[ev.key] += float(ev.device_time_total)
            span_host_us[ev.key] += float(ev.cpu_time_total)
    log(f"[4 profile] profiled run {wall_prof:.1f}s, reading the profile "
        f"{time.monotonic() - t0 - wall_prof:.1f}s")
    busy_us = sum(groups.values())
    if busy_us <= 0.0:
        log("[4 profile] the profiler recorded no device time: device busy "
            "and idle share not measured")
    n_pf = eng.n_prefill_waves + eng.n_chunk_calls
    pf_us = (span_us["engine.prefill_wave"] + span_us["engine.prefill_chunks"]
             + groups["flash_prefill"])
    dec_us = span_us["engine.decode"] + groups["paged_decode"]

    def ms_per(us, n):
        return us / 1e3 / n if us > 0.0 and n > 0 else None

    res = {"wall_s_unprofiled": wall, "wall_s_profiled": wall_prof,
           "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / wall if busy_us else None,
           "kernel_ms": {k: v / 1e3 for k, v in groups.items()},
           "prefill_device_ms_per_call": ms_per(pf_us, n_pf),
           "decode_device_ms_per_iter": ms_per(dec_us, eng.decode_iters),
           "aten_device_ms_per_wave": ms_per(
               span_us["engine.prefill_wave"], eng.n_prefill_waves),
           "aten_device_ms_per_chunk_call": ms_per(
               span_us["engine.prefill_chunks"], eng.n_chunk_calls),
           "phase_share_of_busy": (pf_us + dec_us) / busy_us
           if busy_us else None,
           "span_aten_device_ms": {k: v / 1e3 for k, v in span_us.items()},
           "span_host_ms_profiled": {k: v / 1e3
                                     for k, v in span_host_us.items()},
           "prefill_waves": eng.n_prefill_waves,
           "chunk_calls": eng.n_chunk_calls,
           "decode_iters": eng.decode_iters}
    log(f"[4 profile] {json.dumps(res)}")
    for us, n, key in sorted(rows, reverse=True)[:8]:
        log(f"[4 profile]   {us / 1e3:10.3f} ms {n:6d} x {key[:90]}")
    return res


# --------------------------------------------------------------------------- #
# phase 5: greedy parity at full width, 4 layers, float32
# --------------------------------------------------------------------------- #
def phase_parity(torch, seed: int) -> None:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3_8b").with_(num_layers=4, dtype="float32",
                                       param_dtype="float32")
    log("[5 parity] qwen3-8b full width cut to 4 layers (the only depth "
        "cut), float32, TF32 off")
    eng = ServingEngine(cfg, max_batch=4, capacity=512, seed=seed,
                        device="cuda")
    rng = np.random.default_rng(seed + 7)
    reqs = [GenRequest(prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(16, 300)))],
        params=SamplingParams(max_new_tokens=int(rng.integers(8, 24))))
        for _ in range(6)]
    eng.run(reqs)
    for g in reqs:
        want = _isolated_greedy(torch, model, cfg, eng.params, g.prompt,
                                g.params.max_new_tokens, capacity=512)
        if g.output != want:
            raise AssertionError(f"greedy parity: request {g.rid} engine "
                                 f"{g.output} != isolated {want}")
    log(f"[5 parity] {len(reqs)} greedy streams equal to isolated "
        f"prefill + decode_step")


def _isolated_greedy(torch, model, cfg, params, prompt, n, capacity):
    """One request alone: prefill, seed a fresh cache, greedy decode_step."""
    toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
    logits, caches = model.prefill(cfg, params, toks, last_only=True)
    cache = model.init_cache(cfg, 1, capacity, device="cuda")
    model.seed_cache(cfg, cache, caches, len(prompt))
    cur = int(logits[0].argmax())
    out = [cur]
    for i in range(n - 1):
        lg = model.decode_step(
            cfg, params, torch.tensor([[cur]], device="cuda"),
            torch.tensor([len(prompt) + i], device="cuda"), cache)
        cur = int(lg[0].argmax())
        out.append(cur)
    return out


# --------------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    phase_card(torch)
    phase_build()
    kern = phase_kernels(torch, args.seed)
    launches = phase_main_path(torch, args.seed)["launches"]
    phase_parity(torch, args.seed)
    record = {"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
         "replaces": "src/repro/kernels/flash_prefill.py:116",
         "launches": launches["flash_prefill"],
         **{k: kern["flash_prefill"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:122",
         "launches": launches["paged_decode"],
         **{k: kern["paged_decode"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
