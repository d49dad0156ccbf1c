"""Card smoke test of the PyTorch port: build, check and time the CUDA
kernels, then serve qwen3-8b, zamba2-7b, phi3.5-MoE and mistral-nemo-12b
(sliding-window ring caches) at full width through ``ServingEngine``, run
phi3-vision's embedding-frontend prefill, train qwen3-8b at full width
through ``repro_torch.training``, dry-run the production mesh on the host
and run qwen3-8b's sharded prefill_32k and decode_32k steps on a 1x1 mesh.

    python3 chip_smoke.py [--seed N]      # one GPU
    python3 chip_smoke.py --profile-src OTHER_CHECKOUT/src   # phase 4 only

Phases (any failure raises and exits non-zero):
  1. card: require CUDA, print the name and power limit (nvidia-smi);
  2. build both kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a),
     print build seconds and ptxas registers / shared memory; fail if
     ptxas serialises a wgmma of either kernel, if a bf16 decode instance
     spills, or if the SASS of a ``flash_bf16_kernel`` instance lacks
     HGMMA (wgmma) or UTMALDG (TMA), or that of a
     ``paged_decode_bf16_kernel`` instance lacks HGMMA or its copy
     (UTMALDG, or LDGSTS in the cp.async instances for pages that are not
     a multiple of 8 slots); print the bf16 flash plan (tiles, stages, shared memory) of
     each serving shape and the decode plan (splits, CTAs an SM, waves,
     stages, boxes) of each serving decode shape;
  3. each kernel against its plain PyTorch version on the card, float32
     (TF32 off, tol 1e-4) and bfloat16 (one bf16 ulp, see ``TOL``), at the
     test sweeps, at tile and split edges (segments across tile edges,
     chunks over mostly invalid slots, rows that see no key, contexts at
     split boundaries +-1 and 0), at the bf16 flash kernel's 64- and
     128-row tiles (both forced through its plan: segments across a
     128-row edge, Sq and Sk not multiples of 128, hd 112 and 160 causal
     and over a prefix), at hd 96, 112 and 160 with G = 1 and
     G = 4 (flash causal and over a prefix; decode at ctx 0, 1, page and
     split edges +-1, full, in pages of 16 slots and, at hd 128, of 12:
     the bf16 kernel's cp.async copy), and at the serving paths' shapes (qwen3:
     packed prefill, a chunk over a cache row, a packed chunk wave, decode
     at hd 128; zamba2: causal prefill (1, 1536, 32, 112), decode
     (8, 2048, 32, 112); mistral-nemo: causal prefill (1, 10240, 32, 128)
     under the 8192 window with G = 4, decode over four full 8192-slot
     rings; phi3-vision: causal prefill (2, 1152, 32, 96)), and the
     (8, 2048) decode row's heads and contexts in pages of 12 slots under
     a shuffled block table (SDPA over the same keys gathered into rows,
     the gather not timed); at those ten,
     time kernel, plain version and one library call (SDPA, bool mask,
     ``enable_gqa``), and each flash shape also under the other q tile,
     and log each decode shape's plan and the decode wrapper's host
     microseconds a call (the least of 30 runs of 100 calls without a
     sync),
     with CUDA events, each rotating over copies of its
     inputs so that every call finds them cold in L2, and compute each
     kernel's bound from the call's inputs; and phase 12b's shapes:
     causal (1, 32768, 32, 128) (held to the plain version on all 64
     blocks of 512 query rows, whose whole (H, S, S) scores do not fit; timed
     beside SDPA with ``is_causal``, the plain version not timed) and
     decode (8, 32768, 8, 128) at ctx 32768;
  4. the main path: qwen3-8b at its published widths and depth (36 layers,
     bf16, seeded random weights), max_batch 8, capacity 2048, default
     EngineConfig, 12 requests; checks lengths, launch counters, chunk waves
     and megastep windows; prints tokens/s of the unsynchronised run, then
     serves the same workload under ``torch.profiler`` for the device time
     per prefill call and per decode iteration, the aten launches per
     decode iteration and the idle share (one pass over the raw events);
  5. greedy parity: full width cut to 4 layers, float32, TF32 off: the
     engine's greedy streams equal an isolated prefill + decode_step loop;
     5b: with CUDA's Philox generator, megastep windows (K=8) that EOS cuts
     short, or that run on past their last sampling row's EOS, leave the
     sampled streams, completion times, scheduler decisions and generator
     state of K=1 (reduced qwen3, the reference's pressure workload);
  6. KV migration and the fleet (``repro_torch.cluster``), sharing the
     weights of phases 4 and 5:
     a. full width, bf16: a ~1500-token request prefilled on engine A,
        exported and injected into engine B; B's cache row equals A's
        bit for bit, the CRC holds, and B finishes the request;
     b. a unified 2-instance fleet (least-kvc router) at full width on
        the phase-4 workload: every request complete, conservation and
        ``check_fleet_invariants`` hold, both instances serve, decode
        launches equal 36 x the engines' decode iterations;
     c. the same pair disaggregated (prefill, decode): 12 migrations, no
        fallback, invariants hold;
     d. phase 5's setting on a 3-instance disaggregated fleet with a kill
        of instance 1 at t=6 and one corrupted KV migration: the greedy
        streams equal the fault-free engine's bit for bit, the CRC
        rejects the image and the killed instance's work is recovered
        (run right after phase 5, whose weights it takes and frees).
     Each path counts kernel launches from zero; 6b and 6c print tokens/s
     of the unsynchronised run and peak memory beside the card's name and
     power limit;
  7. the recurrent and hybrid families:
     a. zamba2-7b at its published widths and depth (81 Mamba2 layers, the
        shared MHA block at hd 112 13 times), bf16, seeded random
        weights, max_batch 8, capacity 2048, default EngineConfig, on
        phase 4's workload (exact-shape prefill, recomputed chunks):
        every request complete, flash launches a multiple of 13, decode
        13 x the decode iterations; tokens/s of the unsynchronised run,
        then the profiled run as phase 4's;
     b. greedy parity as phase 5's, zamba2-7b at full width cut to 12
        layers (2 shared invocations), float32;
     c. xlstm-125m at its published size, float32: prompts chunked under a
        128-token budget carry their recurrent state from chunk to chunk,
        and the streams equal those of the recompute path;
  8. MoE:
     a. phi3.5-MoE at its published widths (16 experts of 6400, top-2,
        capacity factor 1.25) cut to 24 of 32 layers (the weights of 32
        do not fit one card beside the caches), bf16, on phase 4's
        settings and workload: every request complete, megastep windows,
        flash launches a multiple of 24, decode 24 x the decode
        iterations; tokens/s and peak memory of the unsynchronised run,
        then the profiled run as phase 4's, with the MoE's share of the
        device time (the ``model.moe`` ranges);
     b. greedy parity as phase 5's, phi3.5-MoE at full width cut to 4
        layers, float32, capacity factor 16 (nothing drops);
  9. ring caches:
     a. mistral-nemo-12b at its published widths and depth, bf16, window
        8192 (the reference's long-context window), max_batch 4, capacity
        16384 (rings of 8192 slots), 6 requests of 8400-12000 prompt and
        32-64 output tokens: every request complete, the attention cache
        rows 8192 wide; tokens/s, peak memory and launches;
     b. greedy parity as phase 5's, mistral-nemo at full width cut to 4
        layers, float32, window 8192, prompts of 8300 and 8700 tokens;
 10. phi3-vision-4.2b at its published widths and depth, float32: a
     prefill over 1024 frontend embeddings and 128 tokens (B = 2), seeded
     into a cache, and 8 decode steps equal one prefill over the whole
     sequence within 2e-3;
 11. training:
     a. qwen3-8b at its published widths cut to 12 of 36 layers, bf16
        params, float32 AdamW moments, remat, batch 1 x 4096 tokens (the
        streaming flash attention), 20 steps on the synthetic data: the
        loss falls; median step ms, tokens/s, peak memory, the model-FLOPs
        share, and one profiled step (device busy, idle share, GEMMs);
     b. one float32 train step (TF32 off) of qwen3-8b at full width cut to
        2 layers at S = 2304 on the card and on the CPU from the same
        weights and batch: loss, every grad and every updated param.
 12. sharding and launch:
     a. ``repro_torch.launch.dryrun`` on the host, before any process
        group: a fake process group of 256 ranks, fake tensors, the
        production (32, 8) mesh; qwen3-8b at all four shapes, zamba2-7b
        decode_32k, phi3.5-MoE prefill_32k and arctic-480b train_4k at
        full size, and on the multi-pod (2, 32, 8) mesh of 512 ranks
        qwen3-8b prefill_32k (a batch of 32 over 64 batch ranks) and
        arctic-480b decode_32k, must all trace; prints bytes a card, fits-80GB, the
        roofline terms and the bottleneck; then the two shapes of 12b on a
        fake (1, 1) mesh, for their per-card totals;
     b. qwen3-8b at full width and depth, bf16, seeded, through
        ``build_step`` on a real 1-rank NCCL mesh (1, 1): prefill_32k at
        batch 1 and decode_32k at batch 8 (8 rows of 32768 slots, 38.65 GB
        of caches); greedy tokens equal to the same call without a mesh,
        each layer's kernel launched once a step, the median step ms of
        three and peak memory beside
        the dry-run's total (decode within 15%).
Each model is freed before the next is built. The line before the last is
the kernels' JSON record (launches summed over the serving phases 4, 6,
7a, 8a and 9a and the sharded steps of 12b; the top-level times are the
zamba2 shapes, every timed shape under ``shapes``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HEAD_DIMS_NEW = (96, 112, 160)       # beyond 32/64/128: every config's hd
PEAK_BYTES = 3.35e12
# (atol, rtol). The kernels and their plain versions both accumulate in
# float32 (TF32 off); in bfloat16 each rounds its float32 result once, so
# the two may differ by one bf16 ulp of the output: 2**-7 relative, and
# 1e-3 absolute for outputs near zero.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}
# the reference's long-context sliding window (``LONG_WINDOW`` in
# src/repro/launch/shapes.py, which ``adapt_config`` gives mistral-nemo-12b)
WINDOW = 8192
# the prefill_32k / decode_32k context (``SHAPES`` in launch/shapes.py)
LONG = 32768
# a page that is not a multiple of 8 slots: the bf16 decode kernel copies
# such pages by cp.async (``paged_attention.plan``'s "cp.async" copy)
SMALL_PAGE = 12
SPANS = ("engine.prefill_wave", "engine.prefill_chunks", "engine.decode")
MOE_SPAN = "model.moe"      # nested inside SPANS: a MoE layer's routing + FFN


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
    _check_flash_build(build, info["flash_prefill"]["ptxas"])
    _check_decode_build(build, info["paged_decode"]["ptxas"])


# a wgmma that ptxas serialises (warnings C7510-C7520) waits for each
# product before the next: the kernel would run, slowly, on no pipeline
WGMMA_SERIAL = "wgmma.mma_async instructions are serialized"


def _no_serial_wgmma(name: str, ptxas: str) -> None:
    serial = [ln for ln in ptxas.splitlines() if WGMMA_SERIAL in ln]
    if serial:
        raise AssertionError(f"ptxas serialises wgmma in the {name} "
                             f"kernel:\n" + "\n".join(serial))


def _ptxas_usage(ptxas: str):
    """(entry function, registers, spill store bytes, spill load bytes) of
    each function ptxas compiled."""
    names = re.findall(r"Compiling entry function '(\w+)'", ptxas)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", ptxas)
    regs = re.findall(r"Used (\d+) registers", ptxas)
    return [(fn, int(rg), int(st), int(ld))
            for fn, (st, ld), rg in zip(names, spills, regs)]


def _sass_ops(build, name: str, kernel: str, ops) -> dict:
    """{instance of ``kernel``: the ops of ``ops`` in its SASS} of the
    library ``name``."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build._target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1] if kernel in m[1] else None
            if fn:
                found[fn] = set()
        elif fn:
            found[fn] |= {op for op in ops if op in line}
    return found


def _check_flash_build(build, ptxas: str) -> None:
    """The bf16 flash kernel is the wgmma / TMA one: ptxas serialises no
    wgmma, and the SASS of every ``flash_bf16_kernel`` instance holds
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads). Prints each instance's
    registers and spills, and the plan (tiles, stages, shared memory) of
    each serving shape."""
    from repro_torch.kernels.flash_prefill import plan
    _no_serial_wgmma("flash", ptxas)
    for fn, rg, sp, _ in _ptxas_usage(ptxas):
        m = re.search(r"flash_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)", fn)
        if m:
            log(f"[2 build]   bf16 hd {m[1]}, {64 * int(m[2])} q rows, "
                f"{m[3]} keys: {rg} registers at launch, {sp} bytes spilled")
    found = _sass_ops(build, "flash_prefill", "flash_bf16_kernel",
                      ("HGMMA", "UTMALDG"))
    missing = [f for f, ops in found.items() if ops != {"HGMMA", "UTMALDG"}]
    if not found or missing:
        raise AssertionError(f"flash_bf16_kernel without HGMMA / UTMALDG in "
                             f"its SASS: {missing or 'no instance found'}")
    log(f"[2 build]   SASS: {len(found)} flash_bf16_kernel instances, each "
        f"with HGMMA and UTMALDG")
    for label, shape, kw in FLASH_PLAN_SHAPES:
        p = plan(*shape, **kw)
        log(f"[2 build]   plan {label}: {p['block_q']} q rows x "
            f"{p['block_k']} keys, {p['stages']} stages, "
            f"{p['threads']} threads, {p['smem']} bytes of shared memory")


def _check_decode_build(build, ptxas: str) -> None:
    """The bf16 decode kernel is the TMA / wgmma one: ptxas serialises no
    wgmma and spills nothing in any ``paged_decode_bf16_kernel`` instance,
    and the SASS of each holds ``HGMMA`` (wgmma) and its producer's copy:
    ``UTMALDG`` (TMA loads) in the TMA instances, ``LDGSTS`` (cp.async) in
    the cp.async ones (pages not a multiple of 8 slots). Prints each
    instance's registers and the plan of each serving decode shape."""
    from repro_torch.kernels.paged_attention import plan
    _no_serial_wgmma("paged_decode", ptxas)
    spilled = []
    for fn, rg, st, ld in _ptxas_usage(ptxas):
        m = re.search(r"paged_decode_bf16_kernelILi(\d+)ELi(\d+)ELb(\d)", fn)
        if m:
            log(f"[2 build]   decode bf16 hd {m[1]}, up to {m[2]} heads a "
                f"kv head, {'cp.async' if m[3] == '1' else 'TMA'}: {rg} "
                f"registers, {st} / {ld} bytes spill stores / loads")
            if st or ld:
                spilled.append(fn)
    if spilled:
        raise AssertionError(f"paged_decode_bf16_kernel spills: {spilled}")
    found = _sass_ops(build, "paged_decode", "paged_decode_bf16_kernel",
                      ("HGMMA", "UTMALDG", "LDGSTS"))
    copy = {f: "LDGSTS" if re.search(r"ELb1E", f) else "UTMALDG"
            for f in found}
    wrong = [f for f, ops in found.items() if ops != {"HGMMA", copy[f]}]
    # 6 head dims x 3 builds (up to 4, 8, 16 heads a kv head) x 2 copies
    if len(found) != 36 or wrong or sum(c == "LDGSTS"
                                        for c in copy.values()) != 18:
        raise AssertionError(f"paged_decode_bf16_kernel without HGMMA and "
                             f"its copy (UTMALDG or LDGSTS alone) in its "
                             f"SASS: {wrong or f'{len(found)} instances'}")
    log(f"[2 build]   SASS: {len(found)} paged_decode_bf16_kernel "
        f"instances, each with HGMMA, 18 with UTMALDG and 18 with LDGSTS")
    for label, shape in DECODE_PLAN_SHAPES:
        log(f"[2 build]   decode plan {label}: {_plan_line(plan(*shape))}")


def _plan_line(p: dict) -> str:
    return (f"{p['n_split']} splits of {p['split']} keys, {p['grid']} CTAs "
            f"at {p['ctas_per_sm']} an SM ({p['waves']:.3f} waves), "
            f"{p['stages']} stages of {p['tile']} keys, "
            + (f"TMA boxes of {p['box']} rows" if p.get("copy", "tma") == "tma"
               else "cp.async") + f", {p['smem']} bytes of shared memory")


# (B, H, K, hd, capacity, page) of the serving path's decode calls
DECODE_PLAN_SHAPES = [
    ("full rings (4,8192,8,128) H32", (4, 32, 8, 128, 8192, 8192)),
    ("decode_32k (8,32768,8,128) H32", (8, 32, 8, 128, 32768, 32768)),
    ("rows (8,2048,8,128) H32", (8, 32, 8, 128, 2048, 2048)),
    ("zamba2 (8,2048,32,112) H32", (8, 32, 32, 112, 2048, 2048)),
]


# (B, Sq, Sk, H, hd) and mask modes of the serving path's flash calls
FLASH_PLAN_SHAPES = [
    ("packed prefill", (1, 2048, 2048, 32, 128), dict(segments=True)),
    ("chunk", (1, 512, 2560, 32, 128), dict(positions=True)),
    ("chunk wave", (1, 1152, 6528, 32, 128),
     dict(positions=True, segments=True)),
    ("zamba2", (1, 1536, 1536, 32, 112), {}),
    ("mistral-nemo", (1, 10240, 10240, 32, 128), {}),
    ("phi3-vision", (2, 1152, 1152, 32, 96), {}),
    ("prefill_32k", (1, 32768, 32768, 32, 128), {}),
]


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
L2_BYTES = 50e6


def _copies(n_bytes: float) -> int:
    """How many copies of a call's inputs make a rotation that overflows
    the 50 MB L2 three times, so that each timed call finds its inputs
    cold, as a serving layer does (every layer has its own weights and
    cache)."""
    return max(2, math.ceil(3 * L2_BYTES / n_bytes))


def _time_ms(torch, fns, iters: int = 20) -> float:
    """Mean device ms a call: ``iters`` calls, rotating over ``fns`` (each
    the same call on its own copy of the inputs), captured once in a CUDA
    graph and replayed between two CUDA events, so that the host's cost of
    a launch (Python wrapper, ctypes) does not hide the device's time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:                   # warm: builds, attributes, allocator
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
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

    # tile edges: segments that cross them, a chunk over a row that is
    # mostly POS_INVALID, a window in positions mode, and rows that see no
    # key (queries placed before every key: the mean of V)
    lens = (63, 2, 66, 129)
    seg = torch.repeat_interleave(torch.arange(4, device=dev),
                                  torch.tensor(lens, device=dev))[None].int()
    yield (f"tile-edge segments {lens} hd128", rnd(1, 260, 8, 128),
           rnd(1, 260, 2, 128), rnd(1, 260, 2, 128), dict(segment_ids=seg))
    for C, S, plen, win in [(1024, 40, 5, None), (256, 100, 200, 64)]:
        slot = torch.arange(C, device=dev)
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S, device=dev)])[None].int()
        qpos = (plen + torch.arange(S, device=dev))[None].int()
        yield (f"tile-edge positions C{C} S{S} plen{plen} win{win} hd128",
               rnd(1, S, 8, 128), rnd(1, C + S, 2, 128),
               rnd(1, C + S, 2, 128),
               dict(window=win, q_positions=qpos, kv_positions=kpos))
    qpos = torch.arange(150, device=dev)[None].int()
    kpos = torch.where(torch.arange(200, device=dev) < 30, POS_INVALID,
                       100 + torch.arange(200, device=dev))[None].int()
    yield ("rows with no valid key (q 150, k 200, 130 rows see none)",
           rnd(1, 150, 8, 64), rnd(1, 200, 2, 64), rnd(1, 200, 2, 64),
           dict(q_positions=qpos, kv_positions=kpos))

    # the head dims past 32/64/128 (phi3-vision 96, zamba2-7b 112,
    # stablelm-12b 160) in causal mode, zamba2's exact prefill, with G = 1
    # (MHA) and G = 4, on a tile edge and across three (S = 64, 193); and a
    # chunk over a prefix at each
    for hd in HEAD_DIMS_NEW:
        for H, K in ((4, 4), (8, 2)):
            for S in (64, 193):
                yield (f"causal hd{hd} H{H} K{K} S{S}", rnd(1, S, H, hd),
                       rnd(1, S, K, hd), rnd(1, S, K, hd), {})
        C, S, plen = 128, 70, 65
        slot = torch.arange(C, device=dev)
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S, device=dev)])[None].int()
        qpos = (plen + torch.arange(S, device=dev))[None].int()
        yield (f"positions hd{hd} G1 C{C} S{S} plen{plen}",
               rnd(1, S, 4, hd), rnd(1, C + S, 4, hd), rnd(1, C + S, 4, hd),
               dict(q_positions=qpos, kv_positions=kpos))


def _flash_wide_cases(torch, dtype, gen):
    """Yield (label, q, k, v, kwargs) at the edges of the bf16 kernel's
    128-row, 128-key tiles: segments across a 128-row edge, Sq and Sk not
    multiples of 128 (positions, with and without a window), a chunk wave
    whose chunks cross 128-row edges, and hd 112 and 160 (whose last
    64-wide TMA box is partial) causal and over a prefix."""
    from repro_torch.kernels.ref import POS_INVALID
    from repro_torch.models.attention import chunk_kv_masks
    from repro_torch.serving.engine import packed_chunk_layout
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def prefix(C, S, plen):
        slot = torch.arange(C, device=dev)
        kpos = torch.cat([torch.where(slot < plen, slot, POS_INVALID),
                          plen + torch.arange(S, device=dev)])[None].int()
        return (plen + torch.arange(S, device=dev))[None].int(), kpos

    lens = (120, 17, 130, 60, 2)
    seg = torch.repeat_interleave(torch.arange(5, device=dev),
                                  torch.tensor(lens, device=dev))[None].int()
    yield (f"segments {lens} across 128-row edges hd128",
           rnd(1, 329, 8, 128), rnd(1, 329, 2, 128), rnd(1, 329, 2, 128),
           dict(segment_ids=seg))
    for win in (None, 96):
        qpos, kpos = prefix(300, 141, 250)
        yield (f"positions Sq 141 Sk 441 plen 250 win{win} hd128",
               rnd(1, 141, 8, 128), rnd(1, 441, 2, 128),
               rnd(1, 441, 2, 128),
               dict(window=win, q_positions=qpos, kv_positions=kpos))
    starts, clens = (130, 0, 700), (150, 129, 61)
    pos, sg, ppos, pseg, _ = packed_chunk_layout(starts, clens, 1024)
    pos, sg = torch.from_numpy(pos).to(dev), torch.from_numpy(sg).to(dev)
    kpos, kseg = chunk_kv_masks(1, ppos.shape[1], pos, sg,
                                prefix_positions=torch.from_numpy(ppos).to(
                                    dev),
                                prefix_segment_ids=torch.from_numpy(
                                    pseg).to(dev))
    T, Sk = sum(clens), kpos.shape[1]
    yield (f"chunk wave starts {starts} lens {clens} hd128",
           rnd(1, T, 8, 128), rnd(1, Sk, 2, 128), rnd(1, Sk, 2, 128),
           dict(segment_ids=sg, kv_segment_ids=kseg, q_positions=pos,
                kv_positions=kpos))
    for hd in (112, 160):
        for H, K in ((4, 4), (8, 2)):
            yield (f"causal hd{hd} H{H} K{K} S 200", rnd(1, 200, H, hd),
                   rnd(1, 200, K, hd), rnd(1, 200, K, hd), {})
        qpos, kpos = prefix(200, 141, 150)
        yield (f"positions hd{hd} Sq 141 Sk 341 plen 150",
               rnd(1, 141, 8, hd), rnd(1, 341, 2, hd), rnd(1, 341, 2, hd),
               dict(q_positions=qpos, kv_positions=kpos))


@contextlib.contextmanager
def _flash_plan(**force):
    """The flash wrapper's plan with some of its choices forced (``block_q``:
    64 or 128 q rows), so that small check cases reach both tile sizes."""
    from repro_torch.kernels import flash_prefill as fp
    chosen = fp.plan
    fp.plan = functools.partial(chosen, **force)
    try:
        yield
    finally:
        fp.plan = chosen


def _decode_edge_cases(torch, dtype, gen):
    """Yield (label, q, k_pages, v_pages, block_tables, context_lens) at
    contexts on the split boundaries +-1, ctx 0, page edges +-1, and a row
    ending in the first split beside a full one: at hd 128 (G = 4) in
    pages of 16 slots and of 12 (the bf16 kernel's cp.async copy), and at
    each new head dim with G = 1 and G = 4."""
    from repro_torch.kernels.paged_attention import _sm_count, plan

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    for page, hd, H, K in [(16, 128, 16, 4), (12, 128, 16, 4)] + [
            (16, hd, H, K) for hd in HEAD_DIMS_NEW
            for H, K in ((4, 4), (16, 4))]:
        B, MP = 4, -(-1024 // page)
        cap = page * MP
        p = plan(B, H, K, hd, cap, page, _sm_count(0))
        split, n = p["split"], p["n_split"]
        P = B * MP + 2
        q, kp, vp = rnd(B, H, hd), rnd(P, page, K, hd), rnd(P, page, K, hd)
        bt = torch.randperm(P, device="cuda", generator=gen)[
            :B * MP].reshape(B, MP).int()
        for ctx in ([0, split - 1, split, split + 1], [1, cap, 3, cap - 1],
                    [2 * split + 1, 2 * split - 1, split * (n - 1), 0],
                    [page - 1, page, page + 1, 2 * page + 1]):
            cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
            yield (f"hd{hd} G{H // K} page {page} split {split} x {n}, "
                   f"ctx {ctx}", q, kp, vp, bt, cl)



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
        for bq in ((64,) if dtype == torch.float32 else (64, 128)):
            with _flash_plan(block_q=bq):
                for label, q, k, v, kw in _flash_wide_cases(torch, dtype,
                                                            gen):
                    _check(torch, f"flash {bq}-row tiles {label}",
                           flash_attention(q, k, v, **kw),
                           ref.flash_attention(q, k, v, **kw), dn,
                           flash_errs)
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
        for label, q, kp, vp, bt, cl in _decode_edge_cases(torch, dtype, gen):
            want = ref.paged_decode_attention(q, kp, vp, bt, cl)
            got = paged_decode_attention(q, kp, vp, bt, cl)
            _check(torch, f"paged {label}", got, want, dn, paged_errs)
            if not torch.equal(got, paged_decode_attention(q, kp, vp, bt,
                                                           cl)):
                raise AssertionError(f"paged {label}: not repeatable")
            B, page, K, hd = q.shape[0], kp.shape[1], kp.shape[2], q.shape[2]
            rows_k, rows_v = kp[bt.long()], vp[bt.long()]
            _check(torch, f"decode_attention rows {label}",
                   ops.decode_attention(q, rows_k.reshape(B, -1, K, hd),
                                        rows_v.reshape(B, -1, K, hd), cl),
                   want, dn, paged_errs)

    # ---- the serving path's shapes, bf16: check, time, bound ------------
    dt = torch.bfloat16
    T, H, K, hd = 2048, 32, 8, 128
    lens = _main_segments(torch, T, 8, cpu_gen)
    seg = torch.repeat_interleave(torch.arange(8),
                                  torch.tensor(lens))[None].int().cuda()
    flash_shapes = [(f"packed prefill (1,{T},{H},{hd}) segments {lens}",
                     (torch.randn(1, T, H, hd, generator=gen, device="cuda"),
                      torch.randn(1, T, K, hd, generator=gen, device="cuda"),
                      torch.randn(1, T, K, hd, generator=gen, device="cuda"),
                      dict(segment_ids=seg)))]
    flash_shapes += list(_main_chunk_cases(torch, gen))
    # zamba2-7b's exact prefill: one prompt, causal, MHA at hd 112
    zq = [torch.randn(1, 1536, 32, 112, generator=gen, device="cuda")
          for _ in range(3)]
    flash_shapes.insert(0, ("zamba2 exact prefill (1,1536,32,112) causal",
                            (*zq, {})))
    # mistral-nemo-12b's ring stack (phase 9a): a 10240-token prompt under
    # the 8192-token window, G = 4; phi3-vision's prefill of 1024 patches
    # and 128 tokens (phase 10): causal MHA at hd 96, B = 2
    mq = torch.randn(1, 10240, 32, 128, generator=gen, device="cuda")
    mkv = [torch.randn(1, 10240, 8, 128, generator=gen, device="cuda")
           for _ in range(2)]
    flash_shapes.append((f"mistral-nemo prefill (1,10240,32,128) k/v "
                         f"(1,10240,8,128) causal window {WINDOW}",
                         (mq, *mkv, dict(window=WINDOW))))
    vq = [torch.randn(2, 1152, 32, 96, generator=gen, device="cuda")
          for _ in range(3)]
    flash_shapes.append(("phi3-vision prefill (2,1152,32,96) causal",
                         (*vq, {})))
    flash_recs = []
    for label, (q, k, v, kw) in flash_shapes:
        for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
            qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
            _check(torch, f"flash main-path {label}",
                   flash_attention(qq, kk, vv, **kw),
                   ref.flash_attention(qq, kk, vv, **kw), dn, flash_errs)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        Hq, hdq = q.shape[2], q.shape[3]
        mask = _flash_mask(torch, q.shape[0], q.shape[1], k.shape[1], kw)
        pairs = int(mask.sum())
        ints = sum(t.numel() for t in kw.values()
                   if isinstance(t, torch.Tensor))
        plan = _plan_of(q, k, kw)
        rec = _measure(
            torch, f"flash {label}", (q, k, v),
            lambda q, k, v: flash_attention(q, k, v, **kw),
            lambda q, k, v: ref.flash_attention(q, k, v, **kw),
            lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=True),
            flops=4.0 * pairs * Hq * hdq,
            nbytes=2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * ints,
            other=_other_tiles(plan, kw))
        plan["other_block_q_ms"] = rec.pop("other_ms")
        flash_recs.append(dict(rec, shape=label, max_abs_err=flash_errs[-1],
                               plan=plan))

    flash_recs.append(_flash_long(torch, gen, flash_errs))

    B, C = 8, 2048
    ctx = torch.randint(1, C + 1, (B,), generator=cpu_gen).int().cuda()
    ctx[0], ctx[1] = 1, C
    paged_recs = [_decode_serving(torch, gen, ctx, H, K, hd, paged_errs)
                  for H, K, hd in ((32, 8, 128), (32, 32, 112))]
    # the (8, 2048) row's heads and contexts in pages of SMALL_PAGE slots
    paged_recs.insert(1, _decode_small_pages(torch, gen, ctx, paged_errs))
    # phase 9a's decode: four full rings of WINDOW slots
    rings = torch.full((4,), WINDOW, dtype=torch.int32, device="cuda")
    paged_recs.insert(0, _decode_serving(torch, gen, rings, 32, 8, 128,
                                         paged_errs, C=WINDOW))
    # phase 12b's decode_32k: 8 rows of LONG slots, every one valid
    full = torch.full((8,), LONG, dtype=torch.int32, device="cuda")
    paged_recs.insert(0, _decode_serving(torch, gen, full, 32, 8, 128,
                                         paged_errs, C=LONG))
    return {
        "flash_prefill": dict(flash_recs[0], max_abs_err_all=max(flash_errs),
                              shapes=flash_recs),
        "paged_decode": dict(paged_recs[-1], max_abs_err_all=max(paged_errs),
                             shapes=paged_recs),
    }


def _other_tiles(plan: dict, kw: dict):
    """The flash kernel on the same call with the other q tile (64 <-> 128
    rows): what the plan's choice is measured against."""
    from repro_torch.kernels.flash_prefill import flash_attention

    def run(q, k, v):
        with _flash_plan(block_q=192 - plan["block_q"]):
            return flash_attention(q, k, v, **kw)
    return run


def _plan_of(q, k, kw) -> dict:
    """The bf16 kernel's tiles and stages for this call."""
    from repro_torch.kernels.flash_prefill import plan
    p = plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
             positions=kw.get("q_positions") is not None,
             segments=kw.get("segment_ids") is not None)
    return {key: p[key] for key in ("block_q", "block_k", "stages")}


def _flash_long(torch, gen, flash_errs: list) -> dict:
    """Phase 12b's prefill_32k: qwen3-8b's causal (1, LONG, 32, 128) over
    k/v (1, LONG, 8, 128). The plain version's (H, S, S) scores do not fit
    the card, so the kernel is held to it on every block of 512 query rows
    (the same function with explicit positions, over the keys up to the
    block's last row) in float32 and bf16, and its time is set beside
    SDPA's (``is_causal``) only."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_attention
    S, H, K, hd = LONG, 32, 8, 128
    q = torch.randn(1, S, H, hd, generator=gen, device="cuda")
    k = torch.randn(1, S, K, hd, generator=gen, device="cuda")
    v = torch.randn(1, S, K, hd, generator=gen, device="cuda")
    pos = torch.arange(S, device="cuda")[None]
    label = f"qwen3 prefill_32k (1,{S},{H},{hd}) k/v (1,{S},{K},{hd}) causal"
    for dtype, dn in ((torch.float32, "float32"), (torch.bfloat16,
                                                   "bfloat16")):
        qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
        got = flash_attention(qq, kk, vv)
        atol, rtol = TOL[dn]
        worst = 0.0
        for r0 in range(0, S, 512):
            rows, keys = slice(r0, r0 + 512), slice(0, r0 + 512)
            want = ref.flash_attention(
                qq[:, rows], kk[:, keys], vv[:, keys],
                q_positions=pos[:, rows], kv_positions=pos[:, keys])
            err = (got[:, rows].float() - want.float()).abs().max().item()
            if not math.isfinite(err) or not torch.allclose(
                    got[:, rows].float(), want.float(), atol=atol,
                    rtol=rtol):
                raise AssertionError(
                    f"flash {label} rows {r0}-{r0 + 511} {dn} disagrees "
                    f"with its plain version: max_abs_err {err}")
            worst = max(worst, err)
            del want
        log(f"[3 kernels] flash {label} all {S // 512} blocks of 512 rows "
            f"{dn}: max_abs_err {worst:.3e} (atol {atol:g}, rtol {rtol:g}) "
            f"ok")
        flash_errs.append(worst)
        del got
    q, k, v = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
    n = _copies(sum(t.numel() * t.element_size() for t in (q, k, v)))
    sets = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                          for _ in range(n - 1)]
    rec = {"ms": _time_ms(torch, [lambda s=s: flash_attention(*s)
                                  for s in sets], 5),
           "plain_ms": None,
           "library_ms": _time_ms(torch, [
               lambda s=s: F.scaled_dot_product_attention(
                   s[0].transpose(1, 2), s[1].transpose(1, 2),
                   s[2].transpose(1, 2), is_causal=True, enable_gqa=True)
               for s in sets], 5),
           "copies": n}
    plan = _plan_of(q, k, {})
    plan["other_block_q_ms"] = _time_ms(
        torch, [lambda s=s: _other_tiles(plan, {})(*s) for s in sets], 5)
    del sets
    pairs = S * (S + 1) // 2
    rec.update(_bound(4.0 * pairs * H * hd,
                      2.0 * (2 * q.numel() + k.numel() + v.numel()),
                      "bfloat16"))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"[3 kernels] flash {label} bf16 timing ({n} input copies): kernel "
        f"{rec['ms']:.4f} ms, plain not measured (its scores do not fit), "
        f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms"
        f" ({rec['bound_by']}), {100 * rec['share_of_bound']:.1f}% of bound; "
        f"under the other plan {plan['other_block_q_ms']:.4f} ms")
    return dict(rec, shape=label, max_abs_err=flash_errs[-1], plan=plan)


def _decode_serving(torch, gen, ctx, H: int, K: int, hd: int,
                    paged_errs: list, C: int = 2048) -> dict:
    """A serving decode shape (B rows of C slots, contexts ``ctx`` (B,)):
    check it in f32 and bf16 through the contiguous rows and a block
    table, then time kernel, plain version and SDPA in bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import (
        _sm_count, paged_decode_attention, plan)
    dt = torch.bfloat16
    B = ctx.shape[0]
    ck = torch.randn(B, C, K, hd, generator=gen, device="cuda").to(dt)
    cv = torch.randn(B, C, K, hd, generator=gen, device="cuda").to(dt)
    qd = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    ps = ops.page_size(C)
    mp = C // ps
    bt = (torch.arange(B)[:, None] * mp + torch.arange(mp)[None]).int().cuda()
    for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
        a, b_, c_ = qd.to(dtype), ck.to(dtype), cv.to(dtype)
        want = ref.paged_decode_attention(
            a, b_.reshape(B * mp, ps, K, hd), c_.reshape(B * mp, ps, K, hd),
            bt, ctx)
        _check(torch, f"decode_attention ({B},{C},{K},{hd}) H{H} "
                      f"ctx {ctx.tolist()}",
               ops.decode_attention(a, b_, c_, ctx), want, dn, paged_errs)
        _check(torch, f"paged ({B},{C},{K},{hd}) H{H} through its block "
                      f"table",
               paged_decode_attention(a, b_.reshape(B * mp, ps, K, hd),
                                      c_.reshape(B * mp, ps, K, hd), bt, ctx),
               want, dn, paged_errs)
    err = paged_errs[-2]
    dmask = (torch.arange(C, device="cuda")[None] < ctx[:, None].long())
    toks = int(ctx.sum())
    label = f"({B},{C},{K},{hd}) H{H} ctx {ctx.tolist()}"
    p = plan(B, H, K, hd, C, C, _sm_count(0))
    host_us = _host_us(torch, lambda: ops.decode_attention(qd, ck, cv, ctx))
    log(f"[3 kernels] paged_decode {label} plan: {_plan_line(p)}; wrapper "
        f"{host_us:.2f} us a call on the host")
    rec = _measure(
        torch, f"paged_decode {label}", (qd, ck, cv),
        lambda q, k, v: ops.decode_attention(q, k, v, ctx),
        lambda q, k, v: ref.paged_decode_attention(
            q, k.view(B * mp, ps, K, hd), v.view(B * mp, ps, K, hd), bt, ctx),
        lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=dmask[:, None, None], enable_gqa=True),
        flops=4.0 * toks * H * hd,
        nbytes=2.0 * (2 * toks * K * hd + 2 * qd.numel()) + 4.0 * B,
        iters=50)
    return dict(rec, shape=label, max_abs_err=err, host_us=host_us,
                plan={k: p[k] for k in ("split", "n_split", "ctas_per_sm",
                                        "waves", "stages", "copy", "box")})


def _decode_small_pages(torch, gen, ctx, paged_errs, H: int = 32, K: int = 8,
                        hd: int = 128, page: int = SMALL_PAGE) -> dict:
    """The (8, 2048) serving row's heads and contexts in pages of ``page``
    slots (not a multiple of 8: the bf16 kernel's cp.async copy) under a
    shuffled block table of MP = ceil(2048 / page) pages a row: checked in
    f32 and bf16, then kernel and plain version timed in bf16 beside SDPA
    over the same keys gathered into rows (the gather not timed). Nothing
    on the serving path launches this shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        _sm_count, paged_decode_attention, plan)
    dt = torch.bfloat16
    B = ctx.shape[0]
    MP = -(-2048 // page)
    P = B * MP + 5
    kp = torch.randn(P, page, K, hd, generator=gen, device="cuda").to(dt)
    vp = torch.randn(P, page, K, hd, generator=gen, device="cuda").to(dt)
    qd = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    bt = torch.randperm(P, generator=gen, device="cuda")[:B * MP].reshape(
        B, MP).int()
    label = f"({B},{MP}x{page},{K},{hd}) H{H} ctx {ctx.tolist()}"
    for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
        a, b_, c_ = qd.to(dtype), kp.to(dtype), vp.to(dtype)
        got = paged_decode_attention(a, b_, c_, bt, ctx)
        _check(torch, f"paged pages of {page} {label}", got,
               ref.paged_decode_attention(a, b_, c_, bt, ctx), dn,
               paged_errs)
        if not torch.equal(got, paged_decode_attention(a, b_, c_, bt, ctx)):
            raise AssertionError(f"paged pages of {page}: not repeatable")
    err = paged_errs[-1]
    p = plan(B, H, K, hd, MP * page, page, _sm_count(0))
    if p["copy"] != "cp.async":
        raise AssertionError(f"pages of {page}: plan {p}")
    C = MP * page
    dmask = torch.arange(C, device="cuda")[None] < ctx[:, None].long()
    toks = int(ctx.sum())

    def rows(t):
        return t[bt.long()].reshape(B, C, K, hd)

    log(f"[3 kernels] paged_decode pages of {page} {label} plan: "
        f"{_plan_line(p)}")
    rec = _measure(
        torch, f"paged_decode pages of {page} {label}",
        (qd, kp, vp, rows(kp), rows(vp)),
        lambda q, k, v, rk, rv: paged_decode_attention(q, k, v, bt, ctx),
        lambda q, k, v, rk, rv: ref.paged_decode_attention(q, k, v, bt, ctx),
        lambda q, k, v, rk, rv: F.scaled_dot_product_attention(
            q[:, :, None], rk.transpose(1, 2), rv.transpose(1, 2),
            attn_mask=dmask[:, None, None], enable_gqa=True),
        flops=4.0 * toks * H * hd,
        nbytes=2.0 * (2 * toks * K * hd + 2 * qd.numel())
        + 4.0 * (B + B * MP), iters=50)
    return dict(rec, shape=f"pages of {page} {label}", max_abs_err=err,
                host_us=None,
                plan={k: p[k] for k in ("split", "n_split", "ctas_per_sm",
                                        "waves", "stages", "copy", "box")})


def _host_us(torch, call, n: int = 100, batches: int = 30) -> float:
    """Host microseconds a call of ``call`` (the wrapper's Python, its
    tensor setup and the launch through ctypes): the least over
    ``batches`` runs of ``n`` calls without a sync, each few enough that
    the launch queue never fills and blocks. The host is shared, and a
    run that a neighbour slowed says nothing of the wrapper: the least is
    what the wrapper itself costs."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    per_call = []
    gc.disable()
    try:
        for _ in range(batches):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            per_call.append((time.perf_counter() - t0) / n)
            torch.cuda.synchronize()
    finally:
        gc.enable()
    return 1e6 * min(per_call)


def _flash_mask(torch, B: int, Sq: int, Sk: int, kw: dict):
    """The (B, Sq, Sk) causal mask of ``ref.flash_attention`` for these
    mask arguments: what a library call is given, and what the bound
    counts."""
    from repro_torch.kernels.ref import POS_INVALID
    if kw.get("q_positions") is not None:
        ii = kw["q_positions"][:, :, None]
        jj = kw["kv_positions"][:, None, :]
        mask = (jj < POS_INVALID) & (jj <= ii)
    else:
        ii = torch.arange(Sq, device="cuda")[None, :, None]
        jj = torch.arange(Sk, device="cuda")[None, None, :]
        mask = jj <= ii
    if kw.get("window") is not None:
        mask = mask & (jj > ii - kw["window"])
    if kw.get("segment_ids") is not None:
        sk = kw.get("kv_segment_ids")
        sk = kw["segment_ids"] if sk is None else sk
        mask = mask & (kw["segment_ids"][:, :, None] == sk[:, None, :])
    return mask.expand(B, Sq, Sk)


def _measure(torch, label, inputs, kernel, plain, library, *, flops,
             nbytes, iters: int = 20, other=None) -> dict:
    """Time the kernel, its plain version and one library call on the
    same inputs, each rotating over enough copies of ``inputs`` that every
    call finds them cold in L2; the bound from this call's flops and
    bytes. ``other``, if given, is the kernel under another plan, timed
    likewise (``other_ms``)."""
    n = _copies(sum(t.numel() * t.element_size() for t in inputs))
    sets = [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(n - 1)]
    rec = {"ms": _time_ms(torch, [lambda s=s: kernel(*s) for s in sets],
                          iters),
           "plain_ms": _time_ms(torch, [lambda s=s: plain(*s) for s in sets],
                                5),
           "library_ms": _time_ms(torch, [lambda s=s: library(*s)
                                          for s in sets], iters),
           "copies": n}
    if other is not None:
        rec["other_ms"] = _time_ms(torch, [lambda s=s: other(*s)
                                           for s in sets], iters)
    del sets
    rec.update(_bound(flops, nbytes, "bfloat16"))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"[3 kernels] {label} bf16 timing ({n} input copies, cold L2): "
        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), {100 * rec['share_of_bound']:.1f}% of bound"
        + (f"; under the other plan {rec['other_ms']:.4f} ms"
           if other is not None else ""))
    return rec


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
    flash_attention.plans = {}
    paged_decode_attention.launches = 0
    paged_decode_attention.plans = {}
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
    if launches["paged_decode"] != L * eng.decode_iters:
        raise AssertionError(
            f"paged_decode: {launches['paged_decode']} launches for "
            f"{eng.decode_iters} decode iterations of {L} layers")
    if eng.n_blocking_syncs:
        raise AssertionError(f"blocking syncs on the main path: "
                             f"{eng.sync_counts}")
    if eng.n_chunk_calls <= 0:
        raise AssertionError("no chunk wave ran on the main path")
    if eng.n_mega_windows <= 0:
        raise AssertionError("no megastep window ran on the main path")
    toks = sum(len(g.output) for g in reqs)
    res = {
        "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
        # bf16 flash launches by (q rows, keys, stages) of their plan
        "flash_plans": {"x".join(map(str, k)): n
                        for k, n in flash_attention.plans.items()},
        "decode_iters": eng.decode_iters,
        "decode_dispatches": eng.n_decode_dispatches,
        "mega_windows": eng.n_mega_windows,
        "prefill_waves": eng.n_prefill_waves,
        "chunk_calls": eng.n_chunk_calls,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sync_counts": dict(eng.sync_counts),
        "launches": launches,
        # bf16 decode launches by (split, splits, stages, box) of their plan
        "decode_plans": {"x".join(map(str, k)): n for k, n in getattr(
            paged_decode_attention, "plans", {}).items()},
    }
    log(f"[4 main] {json.dumps(res)}")
    params = eng.params
    del eng
    res["profile"] = phase_profile(torch, cfg, params, seed, wall, "4", L)
    return res, params


KERNEL_GROUPS = (   # (the port's kernels, of this checkout and older ones)
    ("flash_prefill", re.compile(r"\(anonymous namespace\)::flash_\w*kernel")),
    ("paged_decode",
     re.compile(r"\(anonymous namespace\)::paged_decode_\w*kernel")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
)


def read_profile(prof) -> dict:
    """One pass over the profiler's raw events (no event tree).

    A device kernel that aten launches is linked to the op that launched
    it; the op's start on the host falls inside one of the engine's ranges
    (``SPANS``), which owns the kernel. The two attention kernels are
    launched through ctypes, outside any op, and are given to their phase
    by name. Returns device us and launches by kernel group, device us and
    launches of the aten kernels in each range, the device us of the aten
    kernels inside the MoE's ranges (``MOE_SPAN``, nested in those), and
    the busiest kernels."""
    import bisect
    from torch.autograd import DeviceType
    spans, moe_spans, op_start, dev = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name in SPANS:
                spans.append((e.start_ns(), e.end_ns(), name))
            elif name == MOE_SPAN:
                moe_spans.append((e.start_ns(), e.end_ns()))
            elif e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and \
                e.name() not in SPANS + (MOE_SPAN,):
            # (the ranges also show on the device timeline: not kernels)
            dev.append((e.linked_correlation_id(), e.name(),
                        e.duration_ns() / 1e3))
    spans.sort()
    moe_spans.sort()
    starts = [s[0] for s in spans]
    moe_starts = [s[0] for s in moe_spans]
    moe_us = 0.0
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    group_n = dict.fromkeys(groups, 0)
    span_us = dict.fromkeys(SPANS, 0.0)
    span_n = dict.fromkeys(SPANS, 0)
    by_name: dict = {}
    for link, name, us in dev:
        group = next((g for g, rx in KERNEL_GROUPS if rx.search(name)),
                     "other")
        groups[group] += us
        group_n[group] += 1
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += us
        tot[1] += 1
        if group in ("flash_prefill", "paged_decode"):
            continue
        t = op_start.get(link)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t < spans[i][1]:
            span_us[spans[i][2]] += us
            span_n[spans[i][2]] += 1
        j = bisect.bisect_right(moe_starts, t) - 1 if t is not None else -1
        if j >= 0 and t < moe_spans[j][1]:
            moe_us += us
    top = sorted(((v[0], v[1], k) for k, v in by_name.items()),
                 reverse=True)[:8]
    return {"groups": groups, "group_launches": group_n, "span_us": span_us,
            "span_launches": span_n, "top": top, "moe_us": moe_us}


def phase_profile(torch, cfg, params, seed: int, wall: float, tag: str,
                  n_attn: int) -> dict:
    """Where the time goes: the phase's workload again, on a fresh engine
    with the same weights and seed, under ``torch.profiler``, read in one
    pass by ``read_profile``. A phase's device time is that of the aten
    kernels inside its ranges plus its attention kernels (flash: prefill
    waves and chunk calls; paged decode: decode). A prefill call is one
    forward pass of the stack, which launches flash once in each of its
    ``n_attn`` attention layers (a packed wave or a chunk call of qwen3;
    one exact-shape prompt or recomputed chunk of zamba2). The idle share
    is 1 - (device kernel time / wall time of the unprofiled run of the
    same workload)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, max_batch=8, capacity=2048, seed=seed,
                        device="cuda")
    reqs = _workload(cfg, seed)
    torch.cuda.synchronize()
    flash0 = flash_attention.launches
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    wall_prof = time.monotonic() - t0
    t1 = time.monotonic()
    rp = read_profile(prof)
    del prof
    log(f"[{tag} profile] profiled run {wall_prof:.1f}s, reading the "
        f"profile {time.monotonic() - t1:.1f}s")
    groups, span_us = rp["groups"], rp["span_us"]
    busy_us = sum(groups.values())
    if busy_us <= 0.0:
        log(f"[{tag} profile] the profiler recorded no device time: device "
            f"busy and idle share not measured")
    n_pf = (flash_attention.launches - flash0) // n_attn
    pf_us = (span_us["engine.prefill_wave"] + span_us["engine.prefill_chunks"]
             + groups["flash_prefill"])
    dec_us = span_us["engine.decode"] + groups["paged_decode"]
    iters = eng.decode_iters

    def ms_per(us, n):
        return us / 1e3 / n if us > 0.0 and n > 0 else None

    res = {"wall_s_unprofiled": wall, "wall_s_profiled": wall_prof,
           "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / wall if busy_us else None,
           "kernel_ms": {k: v / 1e3 for k, v in groups.items()},
           "kernel_launches": rp["group_launches"],
           "prefill_device_ms_per_call": ms_per(pf_us, n_pf),
           "decode_device_ms_per_iter": ms_per(dec_us, iters),
           "decode_kernel_ms_per_iter": ms_per(groups["paged_decode"], iters),
           "aten_launches_per_decode_iter":
               rp["span_launches"]["engine.decode"] / iters if iters else None,
           "aten_device_ms_per_wave": ms_per(
               span_us["engine.prefill_wave"], eng.n_prefill_waves),
           "aten_device_ms_per_chunk_call": ms_per(
               span_us["engine.prefill_chunks"], eng.n_chunk_calls),
           "phase_share_of_busy": (pf_us + dec_us) / busy_us
           if busy_us else None,
           "moe_device_ms": rp["moe_us"] / 1e3,
           "moe_share_of_busy": rp["moe_us"] / busy_us if busy_us else None,
           "span_aten_device_ms": {k: v / 1e3 for k, v in span_us.items()},
           "span_aten_launches": rp["span_launches"],
           "prefill_calls": n_pf,
           "prefill_waves": eng.n_prefill_waves,
           "chunk_calls": eng.n_chunk_calls,
           "decode_iters": iters}
    log(f"[{tag} profile] {json.dumps(res)}")
    for us, n, key in rp["top"]:
        log(f"[{tag} profile]   {us / 1e3:10.3f} ms {n:6d} x {key[:90]}")
    return res


# --------------------------------------------------------------------------- #
# phase 5: greedy parity at full width, 4 layers, float32
# --------------------------------------------------------------------------- #
def phase_parity(torch, seed: int, cfg=None, tag: str = "5",
                 capacity: int = 512, lens=None):
    """Greedy streams of the engine equal to an isolated prefill +
    decode_step loop of each request, float32, TF32 off: qwen3-8b at full
    width cut to 4 layers (phase 5), or ``cfg`` (phases 7b, 8b, 9b). Six
    requests of 16-300 prompt and 8-24 output tokens, or ``lens``, a list
    of (prompt, output) lengths."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = get_config("qwen3_8b").with_(num_layers=4, dtype="float32",
                                           param_dtype="float32")
    log(f"[{tag} parity] {cfg.name} full width, {cfg.num_layers} layers "
        f"(the only depth cut), float32, TF32 off")
    eng = ServingEngine(cfg, max_batch=4, capacity=capacity, seed=seed,
                        device="cuda")
    rng = np.random.default_rng(seed + 7)
    reqs = []
    for i in range(len(lens) if lens else 6):
        n_prompt = lens[i][0] if lens else int(rng.integers(16, 300))
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, n_prompt)]
        n_out = lens[i][1] if lens else int(rng.integers(8, 24))
        reqs.append(GenRequest(prompt=prompt,
                               params=SamplingParams(max_new_tokens=n_out)))
    eng.run(reqs)
    for g in reqs:
        want = _isolated_greedy(torch, model, cfg, eng.params, g.prompt,
                                g.params.max_new_tokens, capacity=capacity)
        if g.output != want:
            raise AssertionError(f"[{tag}] greedy parity: request {g.rid} "
                                 f"engine {g.output} != isolated {want}")
    log(f"[{tag} parity] {len(reqs)} greedy streams equal to isolated "
        f"prefill + decode_step ({eng.n_prefill_chunks} chunk grants, "
        f"{eng.decode_iters} decode iterations)")
    return cfg, eng.params


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
# phase 5b: the sampling generator across megastep windows cut by EOS
# --------------------------------------------------------------------------- #
def _rng_engine_run(torch, cfg, params, K: int, eos, seed: int):
    """``tests/test_torch_engine_rng.py``'s run on the card: the
    KVC-saturated pressure workload (12 requests of 16 prompt and 112
    output tokens, every third at temperature 1.3 with top-k 4). Returns
    (fingerprint, the windows that EOS cut short while a row sampled or
    that ran on after their last sampling row's EOS, engine)."""
    import numpy as np
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving import (EngineConfig, GenRequest, SamplingParams,
                                     ServingEngine)
    eng = ServingEngine(
        cfg, params, max_batch=8, capacity=256, rl_accuracy=1.0, seed=seed,
        scheduler_cfg=SchedulerConfig(
            kvc_tokens=512, block_size=16, tfs=256, max_model_len=256,
            max_batch_reqs=8, reserve_frac=0.0, pad_ratio=0.0, bucket=16),
        engine_cfg=EngineConfig(decode_megastep=K), device="cuda")
    cuts, mega = [], eng._mega_fn

    def spy(active, k_iters, need_sample, need_topk, stop_on_eos):
        out = mega(active, k_iters, need_sample, need_topk, stop_on_eos)
        if need_sample:
            act = active.cpu().numpy()
            flags = out[1][:k_iters].cpu().numpy()
            if stop_on_eos:         # cut short at the first EOS
                seen = flags[:-1, act].any()
            else:                   # ran on past the last sampling EOS
                samp = flags[:, act & (eng.temps > 0)]
                seen = samp.any(axis=0).all() \
                    and samp.argmax(axis=0).max() < k_iters - 1
            if seen:
                cuts.append(eng.decode_iters)
        return out

    eng._mega_fn = spy
    rng = np.random.default_rng(0)
    reqs = [GenRequest(
        prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, 16)],
        params=SamplingParams(max_new_tokens=112,
                              temperature=1.3 if i % 3 == 0 else 0.0,
                              top_k=4 if i % 3 == 0 else 0, eos_token=eos))
        for i in range(12)]
    eng.run(reqs)
    s = eng.scheduler
    fp = ([(g.rid, tuple(g.output), g.t_done) for g in reqs],
          tuple(s.iter_completion_counts),
          tuple((r.rid, r.t_complete, r.generated, r.n_preemptions)
                for r in s.completed),
          s.n_preempt_free, s.n_preempt_swap, s.n_underprov, s.n_hosted)
    return fp, cuts, eng


def phase_rng_windows(torch, seed: int) -> dict:
    """5b: with CUDA's Philox generator, a megastep window (K=8) that EOS
    cuts short while a row samples, or that runs on after its last
    sampling row's EOS, leaves the generator where the K=1 path's single
    iterations leave it: equal sampled streams, completion times and
    scheduler decisions, and equal generator states at the end.
    Reduced qwen3 (1 layer, d 64), float32, seeded weights; EOS is the
    first greedy stream's token at 30% and at 70% of its length."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config("qwen3_8b").reduced(layers=1).with_(
        d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256, dtype="float32", param_dtype="float32")
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    t0 = time.monotonic()
    (probe, *_), _, _ = _rng_engine_run(torch, cfg, params, 1, None, seed)
    greedy = probe[1][1]
    res = {}
    for frac in (0.3, 0.7):
        eos = greedy[int(len(greedy) * frac)]
        fp1, _, e1 = _rng_engine_run(torch, cfg, params, 1, eos, seed)
        fp8, cuts, e8 = _rng_engine_run(torch, cfg, params, 8, eos, seed)
        if not cuts:
            raise AssertionError(f"[5b rng] EOS {eos}: no window was cut "
                                 f"short, or ran on past its last "
                                 f"sampling row, while a row sampled")
        if fp8 != fp1 or not torch.equal(e8.gen.get_state(),
                                         e1.gen.get_state()):
            raise AssertionError(f"[5b rng] EOS {eos}: the K=8 engine's "
                                 f"fingerprint or generator differs from "
                                 f"K=1's")
        res[eos] = {"windows": len(cuts), "decode_iters": e8.decode_iters,
                    "dispatches_k8": e8.n_decode_dispatches}
    log(f"[5b rng] K=8 equals K=1 (sampled streams, t_done, decisions, "
        f"generator state) on the card: {json.dumps(res)} "
        f"({time.monotonic() - t0:.1f}s)")
    return res


# --------------------------------------------------------------------------- #
# phase 6: KV migration and the fleet
# --------------------------------------------------------------------------- #
def _zero_launches() -> None:
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    flash_attention.launches = 0
    paged_decode_attention.launches = 0
    paged_decode_attention.plans = {}


def _read_launches(tag: str, L: int, decode_iters=None) -> dict:
    """The counts since ``_zero_launches``: flash a positive multiple of
    the depth, decode a positive multiple of it, and,
    when the path's windows all ran to their end, depth x decode
    iterations."""
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    n = {"flash_prefill": flash_attention.launches,
         "paged_decode": paged_decode_attention.launches}
    if n["flash_prefill"] <= 0 or n["flash_prefill"] % L:
        raise AssertionError(f"[{tag}] flash_prefill: {n} launches, not a "
                             f"positive multiple of {L}")
    if n["paged_decode"] <= 0 or n["paged_decode"] % L:
        raise AssertionError(f"[{tag}] paged_decode: {n}")
    if decode_iters is not None and n["paged_decode"] != L * decode_iters:
        raise AssertionError(f"[{tag}] paged_decode: {n['paged_decode']} "
                             f"launches for {decode_iters} decode "
                             f"iterations of {L} layers")
    return n


def _serve_full(torch, smi: str, cfg, tag: str, reqs, n_attn=None,
                **kw) -> tuple:
    """Build an engine of ``cfg`` on the card with seeded random weights,
    warm it with one short request on a throwaway engine sharing them,
    then serve ``reqs`` once, unsynchronised, with the launch counts and
    the peak memory taken from zero. Checks every request complete, its
    tokens in the vocabulary, the attention launches (flash a multiple of
    the ``n_attn`` attention layers, the depth by default; decode
    ``n_attn`` x decode iterations) and no blocking sync. Returns
    (result, engine)."""
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine
    L = cfg.num_layers
    t0 = time.monotonic()
    eng = ServingEngine(cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eng.params.values())
    log(f"[{tag}] {cfg.name}: {L} layers ({n_attn or L} with attention), "
        f"d {cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card with "
        f"the caches), init {time.monotonic() - t0:.1f}s")
    warm = ServingEngine(cfg, eng.params, device="cuda", **kw)
    warm.run([GenRequest(prompt=list(range(1, 65)),
                         params=SamplingParams(max_new_tokens=4))])
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.monotonic()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _read_launches(tag, n_attn or L, eng.decode_iters)
    for g in reqs:
        if g.status != "completed" or \
                len(g.output) != g.params.max_new_tokens:
            raise AssertionError(f"[{tag}] request {g.rid} incomplete: "
                                 f"{g.status} {len(g.output)}/"
                                 f"{g.params.max_new_tokens}")
        if not all(0 <= t < cfg.vocab_size for t in g.output):
            raise AssertionError(f"[{tag}] request {g.rid}: token out of "
                                 f"vocab")
    if eng.n_blocking_syncs:
        raise AssertionError(f"[{tag}] blocking syncs: {eng.sync_counts}")
    toks = sum(len(g.output) for g in reqs)
    res = {"card": smi, "wall_s": wall, "tokens": toks,
           "tok_per_s": toks / wall, "decode_iters": eng.decode_iters,
           "decode_dispatches": eng.n_decode_dispatches,
           "mega_windows": eng.n_mega_windows,
           "prefill_waves": eng.n_prefill_waves,
           "prefill_chunks": eng.n_prefill_chunks,
           "chunk_calls": eng.n_chunk_calls,
           "prefill_shapes": sorted(eng._prefill_shapes),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sync_counts": dict(eng.sync_counts), "launches": launches}
    return res, eng


def phase_kv_roundtrip(torch, cfg, params, seed: int) -> dict:
    """6a: export a prefilled ~1500-token request from engine A and inject
    it into engine B (shared weights); the image is a byte copy."""
    import numpy as np
    from repro_torch.models.config import ATTN
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine
    from repro_torch.serving.engine import kv_checksum
    L = cfg.num_layers
    a = ServingEngine(cfg, params, max_batch=8, capacity=2048, seed=seed,
                      device="cuda")
    b = ServingEngine(cfg, params, max_batch=8, capacity=2048,
                      seed=seed + 1, device="cuda")
    rng = np.random.default_rng(seed + 11)
    g = GenRequest(prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(1400, 1601)))],
        params=SamplingParams(max_new_tokens=32))
    _zero_launches()
    t = 0.0
    a.submit(g, t)
    while not a.scheduler.gt_queue:
        t += 1.0
        a.step(t)
    slot = a.slot_of[g.rid]
    ctx = int(a._dev["pos"][slot])
    row = {n: a.caches[ATTN][n][:, slot, :ctx].clone() for n in ("k", "v")}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    payload = a.export_kv(g.rid)
    t_export = time.monotonic() - t0
    if payload["kv"] is None or payload["ctx"] != ctx:
        raise AssertionError(f"[6a] export gave no image of {ctx} positions")
    if kv_checksum(payload["kv"]) != payload["kv_crc"]:
        raise AssertionError("[6a] exported image fails its own CRC")
    t0 = time.monotonic()
    rid = b.inject_kv(payload, t)
    torch.cuda.synchronize()
    t_inject = time.monotonic() - t0
    if rid is None or b.n_kv_rejects or rid not in b.slot_of:
        raise AssertionError("[6a] inject did not seat the image")
    for n in ("k", "v"):
        if not torch.equal(b.caches[ATTN][n][:, b.slot_of[rid], :ctx],
                           row[n]):
            raise AssertionError(f"[6a] B's cache row {n} differs from A's")
    while b.has_work() and t < 1000:
        t += 1.0
        b.step(t)
    b.flush()
    if g.status != "completed" or len(g.output) != 32:
        raise AssertionError(f"[6a] B did not finish the request: "
                             f"{g.status}, {len(g.output)}/32 tokens")
    launches = _read_launches("6a", L, a.decode_iters + b.decode_iters)
    image_mb = sum(t.numel() * t.element_size()
                   for t in payload["kv"][ATTN].values()) / 1e6
    res = {"ctx": ctx, "image_mb": image_mb, "export_s": t_export,
           "inject_s": t_inject, "export_reads": a.n_export_reads,
           "sync_counts_a": dict(a.sync_counts), "launches": launches}
    log(f"[6a kv] bitwise round trip at full width, bf16: {json.dumps(res)}")
    return res


def phase_fleet_run(torch, smi: str, cfg, params, seed: int, roles) -> dict:
    """6b / 6c: a 2-instance fleet at full width on the phase-4 workload."""
    from repro_torch.cluster import EngineFleet, check_fleet_invariants
    tag = "6b unified" if roles is None else "6c disagg"
    L = cfg.num_layers
    held = torch.cuda.memory_allocated()     # the weights and leftovers
    fleet = EngineFleet(cfg, n_instances=2, roles=roles, router="least-kvc",
                        seed=seed, params=params, max_batch=8,
                        capacity=2048)
    reqs = _workload(cfg, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.monotonic()
    fleet.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engines = [i.engine for i in fleet.instances]
    iters = sum(e.decode_iters for e in engines)
    launches = _read_launches(tag, L, iters)
    for g in reqs:
        if g.status != "completed" or \
                len(g.output) != g.params.max_new_tokens:
            raise AssertionError(f"[{tag}] request incomplete: {g.status} "
                                 f"{len(g.output)}/"
                                 f"{g.params.max_new_tokens}")
    cons = fleet.conservation()
    if not cons["ok"]:
        raise AssertionError(f"[{tag}] conservation: {cons}")
    check_fleet_invariants(fleet)        # raises on any violation
    served = [len(e.scheduler.completed) for e in engines]
    if roles is None and min(served) < 1:
        raise AssertionError(f"[{tag}] an instance served nothing: {served}")
    if roles is not None and (fleet.n_migrations != len(reqs)
                              or fleet.n_kv_fallbacks):
        raise AssertionError(f"[{tag}] {fleet.n_migrations} migrations, "
                             f"{fleet.n_kv_fallbacks} fallbacks")
    toks = sum(len(g.output) for g in reqs)
    res = {"wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held_before_fleet_gb": held / 1e9,
           "served": served, "decode_iters": [e.decode_iters
                                              for e in engines],
           "migrations": fleet.n_migrations,
           "kv_fallbacks": fleet.n_kv_fallbacks,
           "export_reads": sum(e.n_export_reads for e in engines),
           "sync_counts": [dict(e.sync_counts) for e in engines],
           "launches": launches, "card": smi}
    log(f"[{tag}] {json.dumps(res)}")
    return res


def _top2_gap(torch, model, cfg, params, prompt, prefix) -> float:
    """Top-2 logit gap of an isolated prefill of prompt + prefix."""
    toks = torch.tensor([list(prompt) + list(prefix)], device="cuda")
    logits, _ = model.prefill(cfg, params, toks, last_only=True)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def phase_chaos(torch, cfg, params, seed: int) -> dict:
    """6d: phase 5's setting (float32, TF32 off, 4 layers) on a
    disaggregated 3-instance fleet: one corrupted KV migration and a kill
    of decode instance 1 at t=6, against the fault-free engine."""
    import numpy as np
    from repro_torch.cluster import (EngineFleet, FaultEvent, FaultInjector,
                                     RecoveryConfig, check_fleet_invariants)
    from repro_torch.models import model
    from repro_torch.serving import GenRequest, SamplingParams, ServingEngine

    def workload():
        rng = np.random.default_rng(seed + 7)
        return [GenRequest(prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(16, 300)))],
            params=SamplingParams(max_new_tokens=int(rng.integers(12, 32))))
            for _ in range(8)]
    t0 = time.monotonic()
    kw = dict(max_batch=4, capacity=512, seed=seed, params=params)
    ref = ServingEngine(cfg, device="cuda", **kw)
    ref_reqs = workload()
    ref.run(ref_reqs)
    fleet = EngineFleet(
        cfg, n_instances=3, roles=("prefill", "decode", "decode"),
        router="least-kvc",
        faults=FaultInjector(schedule=[
            FaultEvent(t=1.0, kind="corrupt_kv", count=1),
            FaultEvent(t=6.0, kind="kill", target=1)]),
        recovery=RecoveryConfig(max_retries=4, backoff_base=1.0), **kw)
    reqs = workload()
    _zero_launches()
    fleet.run(reqs)
    torch.cuda.synchronize()
    # a kill can cut a megastep window short: its launched iterations are
    # never replayed, so decode launches are checked as a multiple only
    launches = _read_launches("6d chaos", cfg.num_layers)
    for i, (g, r) in enumerate(zip(reqs, ref_reqs)):
        if g.output != r.output:
            j = next((j for j, (x, y) in enumerate(zip(g.output, r.output))
                      if x != y), min(len(g.output), len(r.output)))
            gap = _top2_gap(torch, model, cfg, params, r.prompt,
                            r.output[:j])
            raise AssertionError(
                f"[6d chaos] request {i}: stream differs from the "
                f"fault-free run at token {j} (fleet {g.output[j:j + 4]}, "
                f"engine {r.output[j:j + 4]}); top-2 logit gap there "
                f"{gap:.3e}")
    cons = fleet.conservation()
    report = check_fleet_invariants(fleet)
    if not (cons["ok"] and cons["kv_rejects"] >= 1
            and fleet.n_recovered >= 1 and not fleet.instances[1].alive):
        raise AssertionError(f"[6d chaos] {cons}, recovered "
                             f"{fleet.n_recovered}")
    res = {"faults": fleet.faults.log, "recovered": fleet.n_recovered,
           "kv_rejects": cons["kv_rejects"],
           "migrations": fleet.n_migrations, "completed": cons["completed"],
           "invariants_ok": report["ok"], "launches": launches,
           "seconds": time.monotonic() - t0}
    log(f"[6d chaos] greedy streams equal to the fault-free engine under "
        f"a kill and a corrupted migration: {json.dumps(res)}")
    return res


def phase_fleet(torch, smi: str, params, chaos: dict, seed: int) -> dict:
    """6a-6c at full width on phase 4's weights; ``chaos`` is 6d's
    result."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_8b")
    t0 = time.monotonic()
    parts = {"6a": phase_kv_roundtrip(torch, cfg, params, seed)}
    torch.cuda.empty_cache()
    parts["6b"] = phase_fleet_run(torch, smi, cfg, params, seed, None)
    torch.cuda.empty_cache()
    parts["6c"] = phase_fleet_run(torch, smi, cfg, params, seed,
                                  ("prefill", "decode"))
    parts["6d"] = chaos
    launches = {k: sum(p["launches"][k] for p in parts.values())
                for k in ("flash_prefill", "paged_decode")}
    log(f"[6 fleet] phase 6a-6c took {time.monotonic() - t0:.1f}s, 6d "
        f"{chaos['seconds']:.1f}s; launches {launches}")
    return {"parts": parts, "launches": launches}


# --------------------------------------------------------------------------- #
# phase 7: the recurrent and hybrid families
# --------------------------------------------------------------------------- #
def phase_zamba(torch, smi: str, seed: int) -> dict:
    """7a: zamba2-7b at its published widths and depth (81 Mamba2 layers,
    d 3584, the shared MHA block at hd 112 after every 6th layer, 13
    times), bf16, seeded random weights, max_batch 8, capacity 2048,
    default EngineConfig, on phase 4's workload: one unsynchronised timed
    run, then one under ``torch.profiler``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = get_config("zamba2_7b")
    n_inv = model.num_shared_invocations(cfg)
    res, eng = _serve_full(torch, smi, cfg, "7a zamba2", _workload(cfg, seed),
                           n_attn=n_inv, max_batch=8, capacity=2048,
                           seed=seed)
    log(f"[7a zamba2] {json.dumps(res)}")
    params = eng.params
    del eng
    res["profile"] = phase_profile(torch, cfg, params, seed, res["wall_s"],
                                   "7a", n_inv)
    p = res["profile"]
    log(f"[7a zamba2] {smi}: {res['tok_per_s']:.2f} tokens/s, device busy "
        f"{p['device_busy_s']} s, idle share {p['idle_share']}, decode "
        f"device ms/iter {p['decode_device_ms_per_iter']}, prefill device "
        f"ms/call {p['prefill_device_ms_per_call']}, launches "
        f"{res['launches']}, peak {res['peak_mem_gb']:.2f} GB")
    return res


def phase_zamba_parity(torch, seed: int) -> dict:
    """7b: zamba2-7b at full width cut to 12 layers (2 shared
    invocations), float32, TF32 off, through ``phase_parity``."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import MAMBA
    cfg = get_config("zamba2_7b").with_(
        num_layers=12, layer_pattern=MAMBA * 12, dtype="float32",
        param_dtype="float32")
    t0 = time.monotonic()
    _zero_launches()
    _, params = phase_parity(torch, seed, cfg, "7b")
    del params
    launches = _read_launches("7b", 2)
    return {"seconds": time.monotonic() - t0, "launches": launches}


def phase_xlstm(torch, seed: int) -> dict:
    """7c: xlstm-125m at its published size, float32: prompts of 200-700
    tokens under a 128-token prefill budget go through several state-carry
    chunks; the streams equal those of the same requests with
    ``incremental_chunk_prefill=False`` (every chunk recomputes its
    prefix)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving import (EngineConfig, GenRequest,
                                     SamplingParams, ServingEngine)
    cfg = get_config("xlstm_125m").with_(dtype="float32",
                                         param_dtype="float32")

    def run(params, ecfg):
        eng = ServingEngine(
            cfg, params, max_batch=4, capacity=1024, seed=seed,
            device="cuda", engine_cfg=ecfg,
            scheduler_cfg=SchedulerConfig(
                kvc_tokens=4 * 1024, block_size=32, tfs=128,
                max_model_len=1024, max_batch_reqs=4))
        rng = np.random.default_rng(seed + 13)
        reqs = [GenRequest(prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(200, 701)))],
            params=SamplingParams(max_new_tokens=int(rng.integers(8, 25))))
            for _ in range(6)]
        eng.run(reqs)
        torch.cuda.synchronize()
        return eng, reqs

    t0 = time.monotonic()
    carry, reqs_c = run(None, None)
    t1 = time.monotonic()
    rec, reqs_r = run(carry.params,
                      EngineConfig(incremental_chunk_prefill=False))
    t2 = time.monotonic()
    if not carry._chunk_rec or rec._chunk_rec:
        raise AssertionError("[7c] the two runs did not take the state-carry "
                             "and the recompute paths")
    for a, b in zip(reqs_c, reqs_r):
        if a.status != "completed" or a.output != b.output:
            raise AssertionError(f"[7c] request {a.rid}: state carry "
                                 f"{a.output} != recompute {b.output}")
    if carry.n_prefill_chunks != rec.n_prefill_chunks \
            or carry.n_prefill_chunks <= 2 * len(reqs_c):
        raise AssertionError(f"[7c] chunks: carry {carry.n_prefill_chunks}, "
                             f"recompute {rec.n_prefill_chunks}")
    res = {"requests": len(reqs_c),
           "prompt_tokens": sum(len(g.prompt) for g in reqs_c),
           "chunks": carry.n_prefill_chunks,
           "carry_s": t1 - t0, "recompute_s": t2 - t1}
    log(f"[7c xlstm] state-carry streams equal to recompute streams: "
        f"{json.dumps(res)}")
    return res


# --------------------------------------------------------------------------- #
# phases 8-10: MoE, ring caches, the embedding frontend
# --------------------------------------------------------------------------- #
def phase_moe(torch, smi: str, seed: int) -> dict:
    """8a: phi3.5-MoE at its published widths (d 4096, 32/8 heads of 128,
    16 experts of 6400, top-2, capacity factor 1.25, vocab 32064) cut to
    24 of its 32 layers, bf16, seeded random weights, max_batch 8,
    capacity 2048, default EngineConfig, on phase 4's workload: one
    unsynchronised timed run, then one under ``torch.profiler`` (with the
    MoE's share of device time)."""
    from repro_torch.configs import get_config
    cfg = get_config("phi3_5_moe_42b").with_(num_layers=24)
    res, eng = _serve_full(torch, smi, cfg, "8a moe", _workload(cfg, seed),
                           max_batch=8, capacity=2048, seed=seed)
    if eng.n_mega_windows <= 0:
        raise AssertionError("[8a] no megastep window ran")
    log(f"[8a moe] {json.dumps(res)}")
    params = eng.params
    del eng
    res["profile"] = p = phase_profile(torch, cfg, params, seed,
                                       res["wall_s"], "8a", cfg.num_layers)
    log(f"[8a moe] {smi}: {res['tok_per_s']:.2f} tokens/s, peak "
        f"{res['peak_mem_gb']:.2f} GB, device busy {p['device_busy_s']} s, "
        f"idle share {p['idle_share']}, decode device ms/iter "
        f"{p['decode_device_ms_per_iter']}, prefill device ms/call "
        f"{p['prefill_device_ms_per_call']}, MoE share of device time "
        f"{p['moe_share_of_busy']}")
    return res


def phase_moe_parity(torch, seed: int) -> dict:
    """8b: phi3.5-MoE at full width cut to 4 layers, float32, TF32 off,
    capacity factor 16 (= the experts, as the reference's own model tests
    set it: nothing drops, so a stream cannot depend on its batch-mates),
    through ``phase_parity``."""
    from repro_torch.configs import get_config
    cfg = get_config("phi3_5_moe_42b").with_(
        num_layers=4, capacity_factor=16.0, dtype="float32",
        param_dtype="float32")
    t0 = time.monotonic()
    _zero_launches()
    _, params = phase_parity(torch, seed, cfg, "8b")
    del params
    return {"seconds": time.monotonic() - t0,
            "launches": _read_launches("8b", cfg.num_layers)}


def _ring_workload(cfg, seed: int):
    """Six prompts of 8400-12000 tokens, each longer than the window, with
    32-64 greedy outputs."""
    import numpy as np
    from repro_torch.serving import GenRequest, SamplingParams
    rng = np.random.default_rng(seed + 17)
    return [GenRequest(prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(8400, 12001)))],
        params=SamplingParams(max_new_tokens=int(rng.integers(32, 65))))
        for _ in range(6)]


def phase_ring(torch, smi: str, seed: int) -> dict:
    """9a: mistral-nemo-12b at its published widths and depth (40 layers,
    d 5120, 32/8 heads of 128, vocab 131072), bf16, with the reference's
    long-context window of ``WINDOW`` tokens, seeded random weights,
    max_batch 4, capacity 16384: the attention caches are rings of WINDOW
    slots, every prompt is longer than the window (every seed rotates,
    decode wraps), and chunks recompute their prefix."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ATTN
    cfg = get_config("mistral_nemo_12b").with_(sliding_window=WINDOW)
    res, eng = _serve_full(torch, smi, cfg, "9a ring",
                           _ring_workload(cfg, seed), max_batch=4,
                           capacity=16384, seed=seed)
    width = eng.caches[ATTN]["k"].shape[2]
    if width != WINDOW or not eng._is_ring(ATTN) or eng.can_migrate_kv \
            or eng._chunk_incremental:
        raise AssertionError(f"[9a] cache rows {width} wide, ring "
                             f"{eng._is_ring(ATTN)}, migrate "
                             f"{eng.can_migrate_kv}, incremental chunks "
                             f"{eng._chunk_incremental}")
    res["cache_width"] = width
    res["cache_gb"] = sum(t.numel() * t.element_size()
                          for t in eng.caches[ATTN].values()) / 1e9
    del eng
    log(f"[9a ring] {json.dumps(res)}")
    log(f"[9a ring] {smi}: {res['tok_per_s']:.2f} tokens/s, peak "
        f"{res['peak_mem_gb']:.2f} GB, caches {res['cache_gb']:.2f} GB, "
        f"launches {res['launches']}")
    return res


def phase_ring_parity(torch, seed: int) -> dict:
    """9b: mistral-nemo-12b at full width cut to 4 layers, float32, TF32
    off, window WINDOW, capacity 16384: two requests of 8300 and 8700
    prompt tokens and 24 outputs through ``phase_parity`` (the isolated
    loop's cache is window-clamped and seeded rotated)."""
    from repro_torch.configs import get_config
    cfg = get_config("mistral_nemo_12b").with_(
        num_layers=4, sliding_window=WINDOW, dtype="float32",
        param_dtype="float32")
    t0 = time.monotonic()
    _zero_launches()
    _, params = phase_parity(torch, seed, cfg, "9b", capacity=16384,
                             lens=[(8300, 24), (8700, 24)])
    del params
    return {"seconds": time.monotonic() - t0,
            "launches": _read_launches("9b", cfg.num_layers)}


def phase_embeds(torch, seed: int) -> dict:
    """10: phi3-vision-4.2b at its published widths and depth (32 layers,
    d 3072, MHA 32 heads of 96), float32, TF32 off: B = 2 requests of
    1024 seeded frontend embeddings (x 0.02) and 128 tokens, prefilled,
    seeded into a cache and decoded 8 steps at positions F+S+t; every
    logit equals that of one prefill over embeds and all 136 tokens within
    2e-3 (the reference's ``tests/test_models.py`` tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("phi3_vision_4_2b").with_(dtype="float32",
                                               param_dtype="float32")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(cfg, gen, "cuda")
    B, F, S, T = 2, cfg.frontend_tokens, 128, 8
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), generator=gen,
                         device="cuda")
    embeds = 0.02 * torch.randn(B, F, cfg.d_model, generator=gen,
                                device="cuda")
    _zero_launches()
    full, _ = model.prefill(cfg, params, toks, embeds=embeds)
    pf, caches = model.prefill(cfg, params, toks[:, :S], embeds=embeds)
    errs = [(pf - full[:, :F + S]).abs().max().item()]
    cache = model.init_cache(cfg, B, F + S + T, device="cuda")
    model.seed_cache(cfg, cache, caches, F + S)
    for t in range(T):
        pos = torch.full((B,), F + S + t, dtype=torch.int32, device="cuda")
        lg, _ = model.decode_step(cfg, params, toks[:, S + t:S + t + 1], pos,
                                  cache)
        errs.append((lg - full[:, F + S + t]).abs().max().item())
    torch.cuda.synchronize()
    launches = _read_launches("10", cfg.num_layers, T)
    res = {"max_abs_err_prefill": errs[0], "max_abs_err_decode": max(errs[1:]),
           "launches": launches, "seconds": time.monotonic() - t0}
    if not all(math.isfinite(e) and e < 2e-3 for e in errs):
        raise AssertionError(f"[10 embeds] logits differ from the full "
                             f"prefill: {errs}")
    log(f"[10 embeds] {cfg.name}: prefill over {F} embeddings + {S} tokens "
        f"and {T} decode steps equal one prefill over all {F + S + T}: "
        f"{json.dumps(res)}")
    del params, cache, caches, full
    return res


# --------------------------------------------------------------------------- #
# phase 11: training
# --------------------------------------------------------------------------- #
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 12, 4096, 20


def phase_train(torch, smi: str, seed: int) -> dict:
    """11a: qwen3-8b at its published widths cut to 12 of 36 layers, bf16
    params, float32 AdamW moments, remat, trained 20 steps at batch 1 and
    S = 4096 (the streaming flash attention) on ``SyntheticDataset(seed)``
    through ``repro_torch.training.train_loop.train``. The loss must fall
    (the mean of the last 5 below that of the first 5). Prints the median
    step ms over steps 5-19, tokens/s, peak memory and the model-FLOPs
    share of the bf16 peak (6 x the matmul weights x the tokens, plus the
    causal attention's 6 L H hd S^2 B; the remat recompute is not
    counted); then one more step under ``torch.profiler``: device busy,
    its idle share against the median step, and the GEMMs' share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_config("qwen3_8b").with_(num_layers=TRAIN_LAYERS)
    opt = AdamWConfig(lr=3e-4, warmup_steps=5)
    log(f"[11a train] {cfg.name} full width, {cfg.num_layers} of 36 layers, "
        f"params {cfg.param_dtype}, moments {opt.state_dtype}, remat "
        f"{cfg.remat}, batch 1 x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, losses = [], []

    def on_step(i, m):
        stamps.append(time.monotonic())
        losses.append(m["loss"])
        log(f"[11a train] step {i:2d} loss {m['loss']:.4f} gnorm "
            f"{m['grad_norm']:.4f}")

    t0 = time.monotonic()
    params, state, _ = train_loop.train(
        cfg, TRAIN_STEPS, opt=opt, batch_size=1, seq_len=TRAIN_SEQ,
        seed=seed, log_every=1, callback=on_step, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    med_ms = statistics.median(step_ms[4:])         # steps 5..19
    first, last = (statistics.fmean(losses[:5]),
                   statistics.fmean(losses[-5:]))
    if not (all(map(math.isfinite, losses)) and last < first):
        raise AssertionError(f"[11a train] the loss did not fall: {losses}")
    n_params = sum(p.numel() for p in params.values())
    n_matmul = n_params - params["tok_embed"].numel()
    T = TRAIN_SEQ
    flops = 6 * n_matmul * T + 6 * cfg.num_layers * cfg.num_heads \
        * cfg.resolved_head_dim * T * T
    res = {"card": smi, "params": n_params, "matmul_params": n_matmul,
           "first_step_s_with_init": stamps[0] - t0,
           "median_step_ms": med_ms, "step_ms": step_ms,
           "tokens_per_s": T / (med_ms / 1e3),
           "peak_mem_gb": peak / 1e9, "model_flops_per_step": flops,
           "mfu": flops / (med_ms / 1e3) / PEAK_FLOPS["bfloat16"],
           "loss_first5": first, "loss_last5": last, "losses": losses}
    batch = train_loop.batch_to(next(SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=T, batch_size=1,
        seed=seed + 1)).batches()), cfg, "cuda")
    step = train_loop.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    res["profiled_step_ms"] = 1e3 * (time.monotonic() - t1)
    rp = read_profile(prof)
    del prof
    groups = rp["groups"]
    res["kernel_launches"] = sum(rp["group_launches"].values())
    busy = sum(groups.values()) / 1e3
    if busy > 0.0:
        res.update(device_busy_ms=busy, idle_share=1.0 - busy / med_ms,
                   gemm_share=groups["gemm"] / 1e3 / busy)
    else:
        log("[11a train] the profiler recorded no device time: device busy "
            "and idle share not measured")
    log(f"[11a train] {json.dumps(res)}")
    for us, n, key in rp["top"]:
        log(f"[11a profile]   {us / 1e3:10.3f} ms {n:6d} x {key[:90]}")
    del params, state, batch
    return res


def phase_train_parity(torch, seed: int) -> dict:
    """11b: one train step of qwen3-8b at full width cut to 2 layers,
    float32, TF32 off, at S = 2304 (above ``FLASH_THRESHOLD``, so
    training's streaming flash attention runs, over a padded last block),
    on the card and on the CPU from the same weights and batch; the CPU
    run is the one the CPU tests hold against the reference. The step is
    ``make_train_step``'s two halves: ``make_grad_fn`` (loss within 1e-5
    relative, every grad within 1e-4 x max|g| of the CPU's leaf), then
    ``apply_updates`` on each device from the CPU's grads (every updated
    param within 1e-5). AdamW's first step moves a param by
    lr * g / (|g| + eps), which turns a grad difference d near g = 0 into
    up to lr / eps * d of param (12000 d here), so the update is held on
    equal grads and the grads on their own."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                                init_state)
    from repro_torch.training.train_loop import batch_to, make_grad_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3_8b").with_(num_layers=2, dtype="float32",
                                       param_dtype="float32")
    opt = AdamWConfig(lr=3e-4, warmup_steps=5)
    S = 2304
    batch = next(SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=1,
        seed=seed)).batches())
    card = model.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                      "cuda")
    cpu = {k: p.cpu() for k, p in card.items()}
    grad_fn = make_grad_fn(cfg)
    t0 = time.monotonic()
    l_gpu, _, g_gpu = grad_fn(card, batch_to(batch, cfg, "cuda"))
    l_gpu = float(l_gpu)
    t1 = time.monotonic()
    l_cpu, _, g_cpu = grad_fn(cpu, batch_to(batch, cfg, "cpu"))
    l_cpu = float(l_cpu)
    t2 = time.monotonic()
    grad_err = max(float((g_gpu[k].cpu() - g).abs().max())
                   / float(g.abs().max()) for k, g in g_cpu.items())
    del g_gpu
    apply_updates(card, {k: g.cuda() for k, g in g_cpu.items()},
                  init_state(card, opt), opt)
    apply_updates(cpu, g_cpu, init_state(cpu, opt), opt)
    param_err = max(float((card[k].detach().cpu() - p.detach()).abs().max())
                    for k, p in cpu.items())
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": loss_rel,
           "grad_err_share_of_max": grad_err, "param_max_abs_err": param_err,
           "card_grad_s": t1 - t0, "cpu_grad_s": t2 - t1,
           "update_s": time.monotonic() - t2}
    log(f"[11b train parity] {json.dumps(res)}")
    if not (loss_rel <= 1e-5 and grad_err <= 1e-4 and param_err <= 1e-5):
        raise AssertionError(f"[11b train parity] the card's step differs "
                             f"from the CPU's: {res}")
    del card, cpu, g_cpu
    return res


# --------------------------------------------------------------------------- #
# --------------------------------------------------------------------------- #
# phase 12: sharding and launch
# --------------------------------------------------------------------------- #
# (arch, shape, on the multi-pod (2, 32, 8) mesh of 512 ranks): the
# multi-pod prefill_32k shards a batch of 32 over 64 batch ranks (padded
# rows), and arctic's decode contracts its experts inside each pod
DRYRUN_COMBOS = [("qwen3-8b", "train_4k", False),
                 ("qwen3-8b", "prefill_32k", False),
                 ("qwen3-8b", "decode_32k", False),
                 ("qwen3-8b", "long_500k", False),
                 ("zamba2-7b", "decode_32k", False),
                 ("phi3.5-moe-42b-a6.6b", "prefill_32k", False),
                 ("arctic-480b", "train_4k", False),
                 ("qwen3-8b", "prefill_32k", True),
                 ("arctic-480b", "decode_32k", True)]
# 12b's cuts of the production shapes' global batch (the whole batch is a
# data-parallel one over 32 cards): one prompt of 32768 tokens; 8 rows of
# 32768 slots (38.65 GB of caches beside 16.4 GB of weights)
SHARDED_BATCH = {"prefill_32k": 1, "decode_32k": 8}
SHARDED_STEPS = 3                   # timed steps of each after a warm one


def phase_dryrun(torch) -> dict:
    """12a: ``repro_torch.launch.dryrun`` on the host: a fake process group
    of 256 ranks, fake tensors, the production (32, 8) mesh, or 512 ranks
    and the multi-pod (2, 32, 8) mesh; each combo of ``DRYRUN_COMBOS`` at
    its full size must trace (``ok``); prints the
    per-device bytes, whether they fit 80 GB, the roofline terms and the
    bottleneck. Then the two shapes of 12b at their cut batches on a fake
    (1, 1) mesh: the per-device totals 12b holds the card's peak to."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    t0 = time.monotonic()
    # one spawned process a combo, each with its own fake world (the
    # training traces take 1-2 minutes each on the host)
    with ProcessPoolExecutor(max_workers=len(DRYRUN_COMBOS),
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as pool:
        futures = [pool.submit(dryrun.sweep, [arch], [shape], [multi],
                               None, False)
                   for arch, shape, multi in DRYRUN_COMBOS]
        found = [f.result()[0] for f in futures]
    recs = []
    for (arch, shape, _), rec in zip(DRYRUN_COMBOS, found):
        if rec["status"] != "ok":
            raise AssertionError(f"[12a dryrun] {arch} {shape} "
                                 f"{rec['mesh']}: {rec['status']} "
                                 f"{rec.get('error')}")
        ro = rec["roofline"]
        log(f"[12a dryrun] {arch} {shape} {rec['mesh']}: "
            f"{rec['mem_per_device'] / 1e9:.3f} GB a card "
            f"(argument {rec['mem_bytes']['argument'] / 1e9:.3f}, temp "
            f"{rec['mem_bytes']['temp'] / 1e9:.3f}, output "
            f"{rec['mem_bytes']['output'] / 1e9:.3f}, alias "
            f"{rec['mem_bytes']['alias'] / 1e9:.3f}), fits 80 GB "
            f"{rec['fits']}; compute {ro['compute_s']:.4g} s, memory "
            f"{ro['memory_s']:.4g} s, collective {ro['collective_s']:.4g}"
            f" s ({json.dumps(rec['collective_bytes'])} B): "
            f"{rec['bottleneck']}; traced in {rec['compile_s']} s")
        recs.append(rec)
    predicted = {}
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(1):
        mesh = init_device_mesh(dryrun.mesh_device(), (1, 1),
                                mesh_dim_names=("data", "model"))
        for name, batch in SHARDED_BATCH.items():
            base = SHAPES[name]
            rec = dryrun.run_one(
                "qwen3-8b", name, False, verbose=False, mesh=mesh,
                cfg=get_config("qwen3-8b"),
                shape=ShapeSpec(name, base.kind, base.seq_len, batch))
            if rec["status"] != "ok":
                raise AssertionError(f"[12a dryrun] qwen3-8b {name} 1x1: "
                                     f"{rec.get('error')}")
            predicted[name] = rec
            log(f"[12a dryrun] qwen3-8b {name} batch {batch} 1x1: "
                f"{rec['mem_per_device'] / 1e9:.3f} GB "
                f"({json.dumps(rec['mem_bytes'])})")
    log(f"[12a dryrun] {time.monotonic() - t0:.1f} s")
    return {"records": recs, "predicted": predicted,
            "seconds": time.monotonic() - t0}


def phase_sharded(torch, smi: str, seed: int, predicted: dict) -> dict:
    """12b: qwen3-8b at its published widths and depth (36 layers, bf16,
    seeded weights) through ``launch.shapes.build_step`` on a real 1-rank
    NCCL ``DeviceMesh`` (1, 1): ``prefill_32k`` at batch 1 (flash, causal,
    S = 32768) and ``decode_32k`` at batch 8 (the decode kernel over 8 rows
    of 32768 slots, each at position 32767). Each step's greedy tokens
    must equal those of ``model.prefill`` / ``model.decode_step`` on the
    same tensors with no mesh; each layer launches its kernel once in each
    of ``SHARDED_STEPS`` timed steps (counts zeroed just before each; the
    step ms is their median); the card's peak memory is
    printed beside the dry-run's per-device total for the same shape, and
    for decode the two agree within 15%."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.launch.shapes import SHAPES, ShapeSpec, build_step
    from repro_torch.models import model
    from repro_torch.models.common import set_mesh_axes
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    out = {"card": smi, "launches": {"flash_prefill": 0, "paged_decode": 0}}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("qwen3-8b")
        L = cfg.num_layers
        for name, batch in SHARDED_BATCH.items():
            base = SHAPES[name]
            decode = base.kind == "decode"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            step, args, _ = build_step(
                cfg, ShapeSpec(name, base.kind, base.seq_len, batch), mesh,
                device="cuda", seed=seed)
            torch.cuda.synchronize()
            build_s = time.monotonic() - t0
            step(*args)                      # warm: DTensor's plans
            torch.cuda.synchronize()
            # the step is host-bound (DTensor dispatch): its median of a
            # few; each step's outputs are freed before the next one runs
            times, res = [], None
            for _ in range(SHARDED_STEPS):
                res = None
                _zero_launches()
                t1 = time.monotonic()
                res = step(*args)
                torch.cuda.synchronize()
                times.append(1e3 * (time.monotonic() - t1))
            step_ms = statistics.median(times)
            n = {"flash_prefill": flash_attention.launches,
                 "paged_decode": paged_decode_attention.launches}
            want = {"flash_prefill": 0 if decode else L,
                    "paged_decode": L if decode else 0}
            if n != want:
                raise AssertionError(f"[12b {name}] launches {n}, want "
                                     f"{want}")
            for k in n:
                out["launches"][k] += n[k]
            peak = torch.cuda.max_memory_allocated()
            toks = res[0].full_tensor()
            del res
            # the same call with no mesh, on the same (whole, 1x1) tensors
            set_mesh_axes(())
            params = {k: v.to_local() for k, v in args[0].items()}
            with torch.no_grad():
                if decode:
                    caches = {kd: {c: t.to_local() for c, t in sub.items()}
                              for kd, sub in args[3].items()}
                    logits, _ = model.decode_step(
                        cfg, params, args[1].to_local(), args[2].to_local(),
                        caches)
                    del caches
                else:
                    logits, _ = model.prefill(
                        cfg, params, args[1]["tokens"].to_local(),
                        last_only=True)
            plain = logits.argmax(dim=-1).to(torch.int32)
            if not torch.equal(toks, plain):
                raise AssertionError(f"[12b {name}] tokens with the mesh "
                                     f"{toks.tolist()} != without "
                                     f"{plain.tolist()}")
            pred = predicted[name]["mem_per_device"]
            out[name] = {"batch": batch, "seq": base.seq_len,
                         "build_s": build_s, "step_ms": step_ms,
                         "steps_ms": times,
                         "launches": n, "peak_gb": peak / 1e9,
                         "predicted_gb": pred / 1e9,
                         "peak_over_predicted": peak / pred,
                         "tokens": toks.tolist()}
            log(f"[12b sharded] {name} batch {batch} on a 1x1 NCCL mesh "
                f"({smi}): step {step_ms:.2f} ms (median of "
                f"{', '.join(f'{t:.2f}' for t in times)}), launches {n} a "
                f"step, peak "
                f"{peak / 1e9:.3f} GB against the dry-run's "
                f"{pred / 1e9:.3f} GB ({100 * (peak / pred - 1):+.1f}%), "
                f"tokens equal without the mesh; built in {build_s:.1f} s")
            if decode and abs(peak / pred - 1) > 0.15:
                raise AssertionError(f"[12b {name}] peak {peak} and the "
                                     f"dry-run's {pred} differ by more than "
                                     f"15%")
            del step, args, params, logits, plain, toks
    finally:
        set_mesh_axes(())
        dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-src", metavar="DIR",
                    help="only serve and profile the phase-4 workload, "
                         "with the repro_torch package found under DIR "
                         "(the src/ of another checkout, for a before/after "
                         "comparison); prints no result line")
    args = ap.parse_args(argv)
    if args.profile_src:
        sys.path.insert(0, str(Path(args.profile_src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = phase_card(torch)
    phase_build()
    if args.profile_src:
        log(f"[profile-src] repro_torch from {repro_torch.__file__}")
        phase_main_path(torch, args.seed)
        return 0
    kern = phase_kernels(torch, args.seed)
    main, params = phase_main_path(torch, args.seed)
    # phase 6d takes phase 5's weights, which are freed before 6a-6c
    chaos = phase_chaos(torch, *phase_parity(torch, args.seed), args.seed)
    phase_rng_windows(torch, args.seed)
    fleet = phase_fleet(torch, smi, params, chaos, args.seed)
    del params
    torch.cuda.empty_cache()
    zamba = phase_zamba(torch, smi, args.seed)
    torch.cuda.empty_cache()
    zamba["parity"] = phase_zamba_parity(torch, args.seed)
    torch.cuda.empty_cache()
    phase_xlstm(torch, args.seed)
    torch.cuda.empty_cache()
    moe = phase_moe(torch, smi, args.seed)
    torch.cuda.empty_cache()
    moe["parity"] = phase_moe_parity(torch, args.seed)
    torch.cuda.empty_cache()
    ring = phase_ring(torch, smi, args.seed)
    torch.cuda.empty_cache()
    ring["parity"] = phase_ring_parity(torch, args.seed)
    torch.cuda.empty_cache()
    phase_embeds(torch, args.seed)
    torch.cuda.empty_cache()
    phase_train(torch, smi, args.seed)
    torch.cuda.empty_cache()
    phase_train_parity(torch, args.seed)
    torch.cuda.empty_cache()
    dry = phase_dryrun(torch)
    sharded = phase_sharded(torch, smi, args.seed, dry["predicted"])
    serving = {"4": main["launches"], "6": fleet["launches"],
               "7a": zamba["launches"], "8a": moe["launches"],
               "9a": ring["launches"], "12b": sharded["launches"]}
    launches = {k: sum(n[k] for n in serving.values())
                for k in ("flash_prefill", "paged_decode")}
    log(f"[launches] by serving phase: {json.dumps(serving)}")
    record = {"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
         "replaces": "src/repro/kernels/flash_prefill.py:116",
         "launches": launches["flash_prefill"],
         **{k: kern["flash_prefill"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "share_of_bound")},
         "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "share_of_bound", "max_abs_err",
                                       "plan")}
                    for r in kern["flash_prefill"]["shapes"]]},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:122",
         "launches": launches["paged_decode"],
         **{k: kern["paged_decode"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "share_of_bound")},
         "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "share_of_bound", "max_abs_err",
                                       "host_us", "plan")}
                    for r in kern["paged_decode"]["shapes"]]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
