"""How far the composition of a call moves the port's float32 results on
the card: opt-13b at full width cut to 4 layers (``chip_smoke.py`` phase
13c's model), TF32 off, seeded random weights. One prompt is prefilled
alone, then after another prompt in one packed call, then before it; and
a cache row built by ``decode_step`` is set against a recompute prefill of
the same prompt and generated tokens. Prints the largest difference of the
cached keys and of the last logits, beside their scale: the rounding that
makes a greedy stream part where two logits tie that closely.

    python3 scripts/composition_check.py [--seed N]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _packed(torch, model, cfg, params, seqs):
    """Last-token logits and layer keys (L, T, K, hd) of one packed
    prefill of ``seqs``."""
    toks, pos, seg = [], [], []
    for i, s in enumerate(seqs):
        toks += s
        pos += range(len(s))
        seg += [i] * len(s)

    def dev(v, dt):
        return torch.tensor([v], dtype=dt, device="cuda")
    logits, caches = model.prefill(
        cfg, params, dev(toks, torch.long), positions=dev(pos, torch.int32),
        segment_ids=dev(seg, torch.int32))
    return logits[0], caches["A"]["k"][:, 0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("opt_13b").with_(num_layers=4, dtype="float32",
                                      param_dtype="float32")
    params = model.init(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed), "cuda")
    rng = np.random.default_rng(args.seed)
    a, b = ([int(t) for t in rng.integers(0, cfg.vocab_size, n)]
            for n in (891, 749))
    P, O = len(a), len(b)
    la, ka = _packed(torch, model, cfg, params, [a])
    lba, kba = _packed(torch, model, cfg, params, [b, a])
    lab, kab = _packed(torch, model, cfg, params, [a, b])
    res = {
        "key_absmax": float(ka.abs().max()),
        "logit_absmax": float(la[-1].abs().max()),
        "logit_std": float(la[-1].std()),
        "after_another_max_dkey": float((ka - kba[:, O:]).abs().max()),
        "after_another_max_dlogit": float((la[-1] - lba[-1]).abs().max()),
        "before_another_max_dkey": float((ka - kab[:, :P]).abs().max()),
        "before_another_max_dlogit": float((la[-1] - lab[P - 1]).abs().max()),
    }
    # a row grown by decode_step against a recompute of prompt + generated
    g = 64
    logits, caches = model.prefill(cfg, params,
                                   torch.tensor([a], device="cuda"),
                                   last_only=True)
    cache = model.init_cache(cfg, 1, P + g, device="cuda")
    model.seed_cache(cfg, cache, caches, P)
    gen = [int(logits[0].argmax())]
    for i in range(g):
        logits = model.decode_step(
            cfg, params, torch.tensor([[gen[-1]]], device="cuda"),
            torch.tensor([P + i], device="cuda"), cache)
        gen.append(int(logits[0].argmax()))
    _, re = model.prefill(cfg, params,
                          torch.tensor([a + gen[:g]], device="cuda"),
                          last_only=True)
    dk = (cache["A"]["k"][:, 0] - re["A"]["k"][:, 0]).abs()
    res["recompute_max_dkey_prompt"] = float(dk[:, :P].max())
    res["recompute_max_dkey_generated"] = float(dk[:, P:].max())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
