"""Compare the port's attention kernels with a variant built from the same
sources, on one card, in turns (kernel, variant, variant, kernel).

    python3 scripts/kernel_variants.py

The variant rounds the softmax weights P to bf16 and multiplies them once
(the lo products of both kernels removed: the flash kernel's ``al``
wgmma; the decode kernel's store of P's lo rows, so that its lo columns
of the one P V product stay zero), where the kernels split P into bf16
hi + lo and multiply both. For each side it prints the worst bf16
error of phase 3's check cases as a share of ``chip_smoke.TOL`` (a share
above 1 fails the check) and the device ms at the serving shapes beside
SDPA's, timed as phase 3 times them (inputs cold in L2, CUDA-graph
replay). Needs a card and nvcc; the last line is a JSON record.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# each kernel's lines that multiply the lo half of P, and how many there are
LO_MMA = {
    "flash_prefill": (re.compile(r".*wgmma::RS<HD>::mma\(acc, al, dv, 1\);\n"),
                      1),
    "paged_decode": (re.compile(
        r".*Ps \+ sw128_offset\(2 \* h \+ 1, .*= lo;\n"), 1),
}


def build_variant(build, name: str) -> ctypes.CDLL:
    """The kernel ``name`` with its lo products removed, built beside the
    others (headers from ``csrc/``)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    pattern, want = LO_MMA[name]
    var, n = pattern.subn("", src)
    if n != want:
        raise RuntimeError(f"{name}.cu: expected {want} lo products, "
                           f"found {n}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"{name}-bf16p.cu"
    so = cu.with_suffix(".so")
    cu.write_text(var)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_prefill import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention

    cs.phase_card(torch)
    build.build_all()
    sides = {"hi+lo": {n: build.load(n) for n in build.KERNELS},
             "bf16 P": {n: build_variant(build, n) for n in build.KERNELS}}
    atol, rtol = cs.TOL["bfloat16"]

    def share(got, want):
        got, want = got.float(), want.float()
        return float(((got - want).abs() / (atol + rtol * want.abs())).max())

    def worst():
        g = torch.Generator(device="cuda").manual_seed(0)
        fl = [share(flash_attention(q, k, v, **kw),
                    ref.flash_attention(q, k, v, **kw))
              for _, q, k, v, kw in cs._flash_cases(torch, torch.bfloat16, g)]
        fl += [share(flash_attention(q, k, v, **kw),
                     ref.flash_attention(q, k, v, **kw))
               for _, (q, k, v, kw) in cs._main_chunk_cases(torch, g)]
        for bq in (64, 128):            # both of the flash kernel's tiles
            with cs._flash_plan(block_q=bq):
                fl += [share(flash_attention(q, k, v, **kw),
                             ref.flash_attention(q, k, v, **kw))
                       for _, q, k, v, kw in cs._flash_wide_cases(
                           torch, torch.bfloat16, g)]
        dc = [share(paged_decode_attention(q, kp, vp, bt, cl),
                    ref.paged_decode_attention(q, kp, vp, bt, cl))
              for _, q, kp, vp, bt, cl in cs._decode_edge_cases(
                  torch, torch.bfloat16, g)]
        return max(fl), max(dc)

    gen = torch.Generator(device="cuda").manual_seed(0)
    T, H, K, hd = 2048, 32, 8, 128
    lens = cs._main_segments(torch, T, 8, torch.Generator().manual_seed(0))
    seg = torch.repeat_interleave(torch.arange(8), torch.tensor(lens))
    shapes = [("packed prefill", (
        torch.randn(1, T, H, hd, generator=gen, device="cuda").bfloat16(),
        torch.randn(1, T, K, hd, generator=gen, device="cuda").bfloat16(),
        torch.randn(1, T, K, hd, generator=gen, device="cuda").bfloat16(),
        dict(segment_ids=seg[None].int().cuda())))]
    shapes += [(label.split(" q ")[0].split(" starts")[0], case)
               for label, case in cs._main_chunk_cases(torch, gen)]
    B, C = 8, 2048
    dec = tuple(torch.randn(*s, generator=gen, device="cuda").bfloat16()
                for s in ((B, H, hd), (B, C, K, hd), (B, C, K, hd)))
    ctx = torch.tensor([1, 2048, 1544, 507, 1456, 111, 680, 1887],
                       dtype=torch.int32, device="cuda")

    def rotation(inputs):
        n = cs._copies(sum(t.numel() * t.element_size() for t in inputs))
        return [inputs] + [tuple(t.clone() for t in inputs)
                           for _ in range(n - 1)]

    def times():
        out = {}
        for label, (q, k, v, kw) in shapes:
            sets = rotation((q, k, v))
            mask = cs._flash_mask(torch, q.shape[0], q.shape[1], k.shape[1],
                                  kw)
            out[label] = (
                cs._time_ms(torch, [lambda s=s: flash_attention(*s, **kw)
                                    for s in sets]),
                cs._time_ms(torch, [
                    lambda s=s: F.scaled_dot_product_attention(
                        s[0].transpose(1, 2), s[1].transpose(1, 2),
                        s[2].transpose(1, 2), attn_mask=mask[:, None],
                        enable_gqa=True) for s in sets]))
        sets = rotation(dec)
        dmask = torch.arange(C, device="cuda")[None] < ctx[:, None].long()
        out["decode"] = (
            cs._time_ms(torch, [lambda s=s: ops.decode_attention(*s, ctx)
                                for s in sets], 50),
            cs._time_ms(torch, [lambda s=s: F.scaled_dot_product_attention(
                s[0][:, :, None], s[1].transpose(1, 2), s[2].transpose(1, 2),
                attn_mask=dmask[:, None, None], enable_gqa=True)
                for s in sets], 50))
        return out

    runs = []
    for side in ("hi+lo", "bf16 P", "bf16 P", "hi+lo"):
        build._libs.update(sides[side])
        fl, dc = worst()
        t = times()
        runs.append({"side": side, "flash_err_share": fl,
                     "decode_err_share": dc,
                     "ms": {k: v[0] for k, v in t.items()},
                     "sdpa_ms": {k: v[1] for k, v in t.items()}})
        cs.log(f"[variants] {side}: worst bf16 error / TOL flash {fl:.4f} "
               f"decode {dc:.4f}; ms " + ", ".join(
                   f"{k} {v[0]:.4f} (SDPA {v[1]:.4f})" for k, v in t.items()))
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
