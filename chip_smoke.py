"""Card smoke test of the PyTorch port: build, check and time the CUDA
kernels, then serve qwen3-8b at full width through ``ServingEngine``.

    python3 chip_smoke.py [--seed N]      # one GPU
    python3 chip_smoke.py --profile-src OTHER_CHECKOUT/src   # phase 4 only

Phases (any failure raises and exits non-zero):
  1. card: require CUDA, print the name and power limit (nvidia-smi);
  2. build both kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a),
     print build seconds and ptxas registers / shared memory;
  3. each kernel against its plain PyTorch version on the card, float32
     (TF32 off, tol 1e-4) and bfloat16 (one bf16 ulp, see ``TOL``), at the
     test sweeps, at tile and split edges (segments across tile edges,
     chunks over mostly invalid slots, rows that see no key, contexts at
     split boundaries +-1 and 0) and at the serving path's shapes (packed
     prefill, a chunk over a cache row, a packed chunk wave, decode); at
     those four, time kernel, plain version and one library call (SDPA,
     bool mask, ``enable_gqa``) with CUDA events, each rotating over copies
     of its inputs so that every call finds them cold in L2, and compute
     each kernel's bound from the call's inputs;
  4. the main path: qwen3-8b at its published widths and depth (36 layers,
     bf16, seeded random weights), max_batch 8, capacity 2048, default
     EngineConfig, 12 requests; checks lengths, launch counters, chunk waves
     and megastep windows; prints tokens/s of the unsynchronised run, then
     serves the same workload under ``torch.profiler`` for the device time
     per prefill call and per decode iteration, the aten launches per
     decode iteration and the idle share (one pass over the raw events);
  5. greedy parity: full width cut to 4 layers, float32, TF32 off: the
     engine's greedy streams equal an isolated prefill + decode_step loop;
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
     power limit.
The line before the last is the kernels' JSON record (launches summed over
phases 4 and 6); the last line is ``{"ok": true, "device": {...}}``.
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


def _decode_edge_cases(torch, dtype, gen):
    """Yield (label, q, k_pages, v_pages, block_tables, context_lens) at
    contexts on the split boundaries +-1, ctx 0, and a row ending in the
    first split beside a full one."""
    from repro_torch.kernels.paged_attention import _sm_count, plan_splits
    B, H, K, hd, page, MP = 4, 16, 4, 128, 16, 64
    cap = page * MP
    split, n = plan_splits(B, K, cap, _sm_count(0))

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    P = B * MP + 2
    q, kp, vp = rnd(B, H, hd), rnd(P, page, K, hd), rnd(P, page, K, hd)
    bt = torch.randperm(P, device="cuda", generator=gen)[:B * MP].reshape(
        B, MP).int()
    for ctx in ([0, split - 1, split, split + 1], [1, cap, 3, cap - 1],
                [2 * split + 1, 2 * split - 1, split * (n - 1), 0]):
        cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        yield (f"split {split} x {n}, ctx {ctx}", q, kp, vp, bt, cl)



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
    flash_recs = []
    for label, (q, k, v, kw) in flash_shapes:
        for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
            qq, kk, vv = q.to(dtype), k.to(dtype), v.to(dtype)
            _check(torch, f"flash main-path {label}",
                   flash_attention(qq, kk, vv, **kw),
                   ref.flash_attention(qq, kk, vv, **kw), dn, flash_errs)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        mask = _flash_mask(torch, q.shape[1], k.shape[1], kw)
        pairs = int(mask.sum())
        ints = sum(t.numel() for t in kw.values()
                   if isinstance(t, torch.Tensor))
        rec = _measure(
            torch, f"flash {label}", (q, k, v),
            lambda q, k, v: flash_attention(q, k, v, **kw),
            lambda q, k, v: ref.flash_attention(q, k, v, **kw),
            lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=True),
            flops=4.0 * pairs * H * hd,
            nbytes=2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * ints)
        flash_recs.append(dict(rec, shape=label, max_abs_err=flash_errs[-1]))

    B, C = 8, 2048
    ck = torch.randn(B, C, K, hd, generator=gen, device="cuda").to(dt)
    cv = torch.randn(B, C, K, hd, generator=gen, device="cuda").to(dt)
    qd = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    ctx = torch.randint(1, C + 1, (B,), generator=cpu_gen).int().cuda()
    ctx[0], ctx[1] = 1, C
    ps = ops.page_size(C)
    mp = C // ps
    bt = (torch.arange(B)[:, None] * mp + torch.arange(mp)[None]).int().cuda()
    for dtype, dn in ((torch.float32, "float32"), (dt, "bfloat16")):
        a, b_, c_ = qd.to(dtype), ck.to(dtype), cv.to(dtype)
        want = ref.paged_decode_attention(
            a, b_.reshape(B * mp, ps, K, hd), c_.reshape(B * mp, ps, K, hd),
            bt, ctx)
        _check(torch, f"decode_attention ({B},{C},{K},{hd}) "
                      f"ctx {ctx.tolist()}",
               ops.decode_attention(a, b_, c_, ctx), want, dn, paged_errs)
        _check(torch, f"paged ({B},{C},{K},{hd}) through its block table",
               paged_decode_attention(a, b_.reshape(B * mp, ps, K, hd),
                                      c_.reshape(B * mp, ps, K, hd), bt, ctx),
               want, dn, paged_errs)
    paged_err_main = paged_errs[-2]
    dmask = (torch.arange(C, device="cuda")[None] < ctx[:, None].long())
    toks = int(ctx.sum())
    pg = _measure(
        torch, f"paged_decode ({B},{C},{K},{hd}) ctx {ctx.tolist()}",
        (qd, ck, cv),
        lambda q, k, v: ops.decode_attention(q, k, v, ctx),
        lambda q, k, v: ref.paged_decode_attention(
            q, k.view(B * mp, ps, K, hd), v.view(B * mp, ps, K, hd), bt, ctx),
        lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=dmask[:, None, None], enable_gqa=True),
        flops=4.0 * toks * H * hd,
        nbytes=2.0 * (2 * toks * K * hd + 2 * qd.numel()) + 4.0 * B,
        iters=50)
    return {
        "flash_prefill": dict(flash_recs[0], max_abs_err_all=max(flash_errs),
                              shapes=flash_recs),
        "paged_decode": dict(pg, max_abs_err=paged_err_main,
                             max_abs_err_all=max(paged_errs)),
    }


def _flash_mask(torch, Sq: int, Sk: int, kw: dict):
    """The (B, Sq, Sk) causal mask of ``ref.flash_attention`` for these
    mask arguments: what a library call is given, and what the bound
    counts."""
    from repro_torch.kernels.ref import POS_INVALID
    if kw.get("q_positions") is not None:
        ii = kw["q_positions"][:, :, None]
        jj = kw["kv_positions"][:, None, :]
        mask = (jj < POS_INVALID) & (jj <= ii)
    else:
        i = torch.arange(Sq, device="cuda")
        mask = (i[None, :] <= i[:, None])[None]
    if kw.get("segment_ids") is not None:
        sk = kw.get("kv_segment_ids")
        sk = kw["segment_ids"] if sk is None else sk
        mask = mask & (kw["segment_ids"][:, :, None] == sk[:, None, :])
    return mask


def _measure(torch, label, inputs, kernel, plain, library, *, flops,
             nbytes, iters: int = 20) -> dict:
    """Time the kernel, its plain version and one library call on the
    same inputs, each rotating over enough copies of ``inputs`` that every
    call finds them cold in L2; the bound from this call's flops and
    bytes."""
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
    del sets
    rec.update(_bound(flops, nbytes, "bfloat16"))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"[3 kernels] {label} bf16 timing ({n} input copies, cold L2): "
        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), {100 * rec['share_of_bound']:.1f}% of bound")
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

    # an older checkout (``--profile-src``) has no combine kernel
    has_combine = hasattr(paged_decode_attention, "combine_launches")
    flash_attention.launches = 0
    paged_decode_attention.launches = 0
    if has_combine:
        paged_decode_attention.combine_launches = 0
    t0 = time.monotonic()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_prefill": flash_attention.launches,
                "paged_decode": paged_decode_attention.launches}
    combine = paged_decode_attention.combine_launches if has_combine \
        else None

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
    if launches["paged_decode"] != L * eng.decode_iters \
            or combine not in (None, launches["paged_decode"]):
        raise AssertionError(
            f"paged_decode: {launches['paged_decode']} launches and {combine}"
            f" combines for {eng.decode_iters} decode iterations of {L} "
            f"layers")
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
        "decode_iters": eng.decode_iters,
        "decode_dispatches": eng.n_decode_dispatches,
        "mega_windows": eng.n_mega_windows,
        "prefill_waves": eng.n_prefill_waves,
        "chunk_calls": eng.n_chunk_calls,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sync_counts": dict(eng.sync_counts),
        "launches": launches,
        "paged_decode_combine_launches": combine,
    }
    log(f"[4 main] {json.dumps(res)}")
    params = eng.params
    del eng
    res["profile"] = phase_profile(torch, cfg, params, seed, wall)
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
    launches of the aten kernels in each range, and the busiest kernels."""
    import bisect
    from torch.autograd import DeviceType
    spans, op_start, dev = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name in SPANS:
                spans.append((e.start_ns(), e.end_ns(), name))
            elif e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and e.name() not in SPANS:
            # (the ranges also show on the device timeline: not kernels)
            dev.append((e.linked_correlation_id(), e.name(),
                        e.duration_ns() / 1e3))
    spans.sort()
    starts = [s[0] for s in spans]
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
    top = sorted(((v[0], v[1], k) for k, v in by_name.items()),
                 reverse=True)[:8]
    return {"groups": groups, "group_launches": group_n, "span_us": span_us,
            "span_launches": span_n, "top": top,
            "combine_launches": sum(v[1] for k, v in by_name.items()
                                    if "paged_decode_combine" in k)}


def phase_profile(torch, cfg, params, seed: int, wall: float) -> dict:
    """Where the time goes: the phase-4 workload again, on a fresh engine
    with the same weights and seed, under ``torch.profiler``, read in one
    pass by ``read_profile``. A phase's device time is that of the aten
    kernels inside its ranges plus its attention kernels (flash: prefill
    waves and chunk calls; paged decode: decode). The idle share is
    1 - (device kernel time / wall time of the unprofiled run of the same
    workload)."""
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
    t1 = time.monotonic()
    rp = read_profile(prof)
    del prof
    log(f"[4 profile] profiled run {wall_prof:.1f}s, reading the profile "
        f"{time.monotonic() - t1:.1f}s")
    groups, span_us = rp["groups"], rp["span_us"]
    busy_us = sum(groups.values())
    if busy_us <= 0.0:
        log("[4 profile] the profiler recorded no device time: device busy "
            "and idle share not measured")
    n_pf = eng.n_prefill_waves + eng.n_chunk_calls
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
           "paged_decode_combine_launches": rp["combine_launches"],
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
           "span_aten_device_ms": {k: v / 1e3 for k, v in span_us.items()},
           "span_aten_launches": rp["span_launches"],
           "prefill_waves": eng.n_prefill_waves,
           "chunk_calls": eng.n_chunk_calls,
           "decode_iters": iters}
    log(f"[4 profile] {json.dumps(res)}")
    for us, n, key in rp["top"]:
        log(f"[4 profile]   {us / 1e3:10.3f} ms {n:6d} x {key[:90]}")
    return res


# --------------------------------------------------------------------------- #
# phase 5: greedy parity at full width, 4 layers, float32
# --------------------------------------------------------------------------- #
def phase_parity(torch, seed: int):
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
# phase 6: KV migration and the fleet
# --------------------------------------------------------------------------- #
def _zero_launches() -> None:
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    flash_attention.launches = 0
    paged_decode_attention.launches = 0
    paged_decode_attention.combine_launches = 0


def _read_launches(tag: str, L: int, decode_iters=None) -> dict:
    """The counts since ``_zero_launches``: flash a positive multiple of
    the depth, decode a multiple with one combine each, and, when the
    path's windows all ran to their end, depth x decode iterations."""
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    n = {"flash_prefill": flash_attention.launches,
         "paged_decode": paged_decode_attention.launches,
         "combine": paged_decode_attention.combine_launches}
    if n["flash_prefill"] <= 0 or n["flash_prefill"] % L:
        raise AssertionError(f"[{tag}] flash_prefill: {n} launches, not a "
                             f"positive multiple of {L}")
    if n["paged_decode"] <= 0 or n["paged_decode"] % L \
            or n["combine"] != n["paged_decode"]:
        raise AssertionError(f"[{tag}] paged_decode: {n}")
    if decode_iters is not None and n["paged_decode"] != L * decode_iters:
        raise AssertionError(f"[{tag}] paged_decode: {n['paged_decode']} "
                             f"launches for {decode_iters} decode "
                             f"iterations of {L} layers")
    return n


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
    combine = sum(p["launches"]["combine"] for p in parts.values())
    log(f"[6 fleet] phase 6a-6c took {time.monotonic() - t0:.1f}s, 6d "
        f"{chaos['seconds']:.1f}s; launches {launches}")
    return {"parts": parts, "launches": launches, "combine_launches": combine}


# --------------------------------------------------------------------------- #
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
    fleet = phase_fleet(torch, smi, params, chaos, args.seed)
    del params
    launches = {k: main["launches"][k] + fleet["launches"][k]
                for k in main["launches"]}
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
                                       "share_of_bound", "max_abs_err")}
                    for r in kern["flash_prefill"]["shapes"]]},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:122",
         "launches": launches["paged_decode"],
         "combine_launches": main["paged_decode_combine_launches"]
         + fleet["combine_launches"],
         **{k: kern["paged_decode"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "share_of_bound")}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
