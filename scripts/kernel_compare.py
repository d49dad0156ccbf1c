"""Time the bf16 kernels of a checkout on one card: the paged decode kernel
at the four serving decode shapes (device ms, the wrapper's host
microseconds a call, each kernel's share of a call, the split plan) and
the flash kernel at the causal G = 1 prefills of phi3-vision and zamba2
(device ms). Device ms as ``chip_smoke.py`` phase 3 times them: inputs
cold in L2, CUDA-graph replay.

    python3 scripts/kernel_compare.py [--src DIR] [--occupancy-plan]
                                      [--waves N] [--label L]

``--src`` takes the ``src/`` of another checkout (unpacked with ``git
archive`` into a git-ignored directory), so that two versions are compared
inside one call, in turns (parent, change, change, parent).
``--f32-out FILE`` also saves the float32 decode outputs at ``chip_smoke.py``
phase 3's float32 decode inputs (its block-table sweep, split and page
edges, and the serving shapes, drawn from one seed) to FILE, and
``--f32-equal FILE...`` (no card needed) says whether such files hold
the same outputs bit for bit.
``--occupancy-plan`` runs a checkout whose decode wrapper still splits by
``plan_splits`` (the ``mma.sync`` kernel, sized for 4 CTAs an SM) with
splits sized for the CTAs that kernel really keeps resident (whole waves
of them), so that the split plan's share of a speed-up is measured apart
from the kernel's. ``--waves N`` sizes a ``paged_attention.plan``
checkout's grid for N waves of resident CTAs (its plan handed N times the
card's SMs). Both patch the checkout's module in this process only. The
last line is a JSON record.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_SM = 132
SMEM_SM = 233472        # shared memory of an H100 SM, 1 KB held a CTA


def _old_kernel_ctas(hd: int, split: int, page: int) -> int:
    """CTAs of the ``mma.sync`` / ``cp.async`` bf16 decode kernel an SM holds:
    its ``bf16_smem_bytes`` (two K and two V tiles of 64 padded rows, the
    16-row Q operand, the split's page list) against the SM's memory."""
    row = hd + 8
    smem = 2 * 4 * 64 * row + 2 * 16 * row + 4 * (split // page + 2)
    return SMEM_SM // (smem + 1024)


def occupancy_plan(hd: int):
    """``plan_splits`` of the older wrapper, sized for whole waves of the
    CTAs its kernel keeps resident at head dim ``hd`` (3 at hd 128)."""
    def plan_splits(batch, kv_heads, capacity, n_sm=N_SM):
        ctas = _old_kernel_ctas(hd, capacity, capacity)
        want = max(1, ctas * n_sm // (batch * kv_heads))
        split = -(-capacity // want)
        split = max(64, -(-split // 64) * 64)
        return split, -(-capacity // split)
    return plan_splits


def _kernel_us(torch, call, n: int = 20) -> dict:
    """Device microseconds a call of each decode kernel ``call`` launches,
    from ``torch.profiler`` over ``n`` calls (inputs warm in L2)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0)
        if "paged_decode" in evt.key and us:
            out[evt.key] = out.get(evt.key, 0.0) + us / n
    return out


def f32_outputs(torch, cs, pa, ops) -> dict:
    """{label: float32 decode output} at phase 3's float32 decode inputs:
    the block-table sweep, ``_decode_edge_cases`` (split and page edges,
    ctx 0, every head dim) and the serving rows, from one seed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    f32 = torch.float32
    out = {}
    for B, H, K, hd, page, MP in [(3, 8, 2, 64, 16, 5), (2, 4, 4, 128, 32, 4),
                                  (1, 8, 1, 64, 8, 7), (4, 2, 2, 32, 16, 3),
                                  (8, 32, 8, 128, 128, 16)]:
        P = B * MP + 3
        q = torch.randn(B, H, hd, generator=gen, device="cuda")
        kp = torch.randn(P, page, K, hd, generator=gen, device="cuda")
        vp = torch.randn(P, page, K, hd, generator=gen, device="cuda")
        bt = torch.randperm(P, generator=cpu_gen)[:B * MP].reshape(
            B, MP).int().cuda()
        choices = [1, page, page + 1, MP * page]
        cl = torch.tensor([choices[i % 4] for i in range(B)],
                          dtype=torch.int32, device="cuda")
        out[f"table B{B} H{H} K{K} hd{hd} page{page} MP{MP}"] = \
            pa.paged_decode_attention(q, kp, vp, bt, cl).cpu()
    for label, q, kp, vp, bt, cl in cs._decode_edge_cases(torch, f32, gen):
        out[f"edge {label}"] = pa.paged_decode_attention(q, kp, vp, bt,
                                                         cl).cpu()
    ctx = torch.randint(1, 2049, (8,), generator=cpu_gen).int()
    ctx[0], ctx[1] = 1, 2048
    for B, C, H, K, hd, cl in [(8, 2048, 32, 8, 128, ctx),
                               (8, 2048, 32, 32, 112, ctx),
                               (4, 8192, 32, 8, 128, [8192] * 4),
                               (2, 32768, 32, 8, 128, [32768] * 2)]:
        q = torch.randn(B, H, hd, generator=gen, device="cuda")
        ck = torch.randn(B, C, K, hd, generator=gen, device="cuda")
        cv = torch.randn(B, C, K, hd, generator=gen, device="cuda")
        cl = torch.as_tensor(cl, dtype=torch.int32).cuda()
        out[f"rows ({B},{C},{K},{hd}) H{H}"] = ops.decode_attention(
            q, ck, cv, cl).cpu()
    return out


def f32_equal(paths) -> int:
    """Whether the ``--f32-out`` files hold the same outputs bit for bit."""
    import torch
    runs = [torch.load(p) for p in paths]
    bad = [k for k in runs[0] if any(
        k not in r or not torch.equal(runs[0][k], r[k]) for r in runs[1:])]
    print(json.dumps({"f32_equal": not bad and all(
        set(r) == set(runs[0]) for r in runs), "files": list(paths),
        "outputs": len(runs[0]), "differ": bad}), flush=True)
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--occupancy-plan", action="store_true")
    ap.add_argument("--label", default="")
    ap.add_argument("--waves", type=int, default=None,
                    help="waves of resident CTAs the decode grid fills")
    ap.add_argument("--f32-out", default=None)
    ap.add_argument("--f32-equal", nargs="+", default=None)
    args = ap.parse_args()
    if args.f32_equal:
        return f32_equal(args.f32_equal)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: no CUDA device")
    import chip_smoke as cs             # (it puts this checkout's src first)
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.flash_prefill import flash_attention
    if not Path(pa.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"kernel_compare: imported {pa.__file__}, not the "
                         f"checkout under {args.src}")
    if args.waves is not None:
        sm_count = pa._sm_count
        pa._sm_count = lambda index: args.waves * sm_count(index)
    cs.phase_card(torch)
    build.build_all()
    if args.f32_out:
        outs = f32_outputs(torch, cs, pa, ops)
        torch.save(outs, args.f32_out)
        cs.log(f"[kernel_compare {args.label}] {len(outs)} float32 decode "
               f"outputs saved to {args.f32_out}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    ctx_2048 = torch.randint(1, 2049, (8,), generator=cpu_gen).int()
    ctx_2048[0], ctx_2048[1] = 1, 2048
    shapes = [("decode_32k (8,32768,8,128) H32", 32, 8, 128,
               torch.full((8,), 32768, dtype=torch.int32)),
              ("full rings (4,8192,8,128) H32", 32, 8, 128,
               torch.full((4,), 8192, dtype=torch.int32)),
              ("rows (8,2048,8,128) H32", 32, 8, 128, ctx_2048),
              ("zamba2 (8,2048,32,112) H32", 32, 32, 112, ctx_2048)]
    out = {"label": args.label, "src": args.src, "waves": args.waves,
           "occupancy_plan": args.occupancy_plan, "shapes": [],
           "flash": []}
    for label, H, K, hd, ctx in shapes:
        if args.occupancy_plan:
            pa.plan_splits = occupancy_plan(hd)
        B, C = ctx.shape[0], int(ctx.max())
        C = max(C, 2048)
        ctx = ctx.cuda()
        q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
        ck = torch.randn(B, C, K, hd, generator=gen, device="cuda").bfloat16()
        cv = torch.randn(B, C, K, hd, generator=gen, device="cuda").bfloat16()
        ps = ops.page_size(C)
        bt = (torch.arange(B)[:, None] * (C // ps)
              + torch.arange(C // ps)[None]).int().cuda()
        want = ref.paged_decode_attention(
            q, ck.view(B * (C // ps), ps, K, hd),
            cv.view(B * (C // ps), ps, K, hd), bt, ctx)
        got = ops.decode_attention(q, ck, cv, ctx)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        atol, rtol = cs.TOL["bfloat16"]
        if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"{label}: max_abs_err {err}")
        n = cs._copies(2 * ck.numel() * 2)
        sets = [(q, ck, cv)] + [(q.clone(), ck.clone(), cv.clone())
                                for _ in range(n - 1)]
        ms = cs._time_ms(torch, [lambda s=s: ops.decode_attention(*s, ctx)
                                 for s in sets], 50)
        del sets
        host = cs._host_us(torch, lambda: ops.decode_attention(q, ck, cv,
                                                               ctx))
        kernels_us = _kernel_us(torch, lambda: ops.decode_attention(
            q, ck, cv, ctx))
        if hasattr(pa, "plan"):
            p = pa._plan(B, H, K, hd, C, C, pa._sm_count(0))
            split = (p["split"], p["n_split"])
        else:
            split = pa.plan_splits(B, K, C)
        toks = int(ctx.sum())
        bound = cs._bound(4.0 * toks * H * hd,
                          2.0 * (2 * toks * K * hd + 2 * q.numel()) + 4.0 * B,
                          "bfloat16")
        rec = {"shape": label, "ms": ms, "host_us": host, "split": split,
               "max_abs_err": err, "kernel_us": kernels_us, **bound}
        cs.log(f"[kernel_compare {args.label}] {json.dumps(rec)}")
        out["shapes"].append(rec)
        del q, ck, cv
        torch.cuda.empty_cache()
    for label, (B, S, H, hd) in (("phi3-vision (2,1152,32,96) causal",
                                  (2, 1152, 32, 96)),
                                 ("zamba2 (1,1536,32,112) causal",
                                  (1, 1536, 32, 112))):
        q, k, v = (torch.randn(B, S, H, hd, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        got = flash_attention(q, k, v)
        want = ref.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        atol, rtol = cs.TOL["bfloat16"]
        if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"flash {label}: max_abs_err {err}")
        n = cs._copies(2 * 3 * q.numel())
        sets = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                              for _ in range(n - 1)]
        ms = cs._time_ms(torch, [lambda s=s: flash_attention(*s)
                                 for s in sets])
        del sets
        pairs = B * S * (S + 1) // 2
        bound = cs._bound(4.0 * pairs * H * hd, 2.0 * 4 * q.numel(),
                          "bfloat16")
        rec = {"shape": label, "ms": ms, "max_abs_err": err, **bound}
        cs.log(f"[kernel_compare {args.label}] flash {json.dumps(rec)}")
        out["flash"].append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
