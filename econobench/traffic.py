"""The one traffic generator: every mix is a data file, ``mixes/<mix>.json``.

A mix gives lognormal prompt and output lengths (by mean or by median, a
shape ``sigma``, and a clip), a correlation between the two, and the SLO
rule. The lengths and the arrival gaps are drawn once, in one order, from the
mix's ``base_seed``; ``--seed`` reorders them within blocks of
``block`` consecutive requests and draws the prompt tokens. So every seed
offers the same work, in another order, and a window of the stream
holds nearly the same requests whatever the seed.

The length arithmetic (a latent shared between prompt and output) and the
deadline rule are copied from ``repro_torch/core/traces.py:generate``:
deadline = due + scale * (t_p + t_g * output tokens), the paper's section 4.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

MIXES = Path(__file__).resolve().parent / "mixes"


@dataclass
class Item:
    """One request of the stream: due time (seconds from the stream's start;
    0 in a closed loop), prompt token ids, output tokens, deadline offset
    (seconds after the due time)."""
    due: float
    prompt: np.ndarray
    out: int
    slo: float


def load_mix(name: str) -> dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def _mu(spec: dict) -> float:
    if "median" in spec:
        return math.log(spec["median"])
    return math.log(spec["mean"]) - 0.5 * spec["sigma"] ** 2


def sizes(mix: dict, n: int):
    """(prompt lengths, output lengths) of ``n`` requests from the mix's
    base seed, as ``traces.generate`` draws them: prompts lognormal and
    clipped; outputs from a latent that mixes the standardised log prompt
    length (weight ``corr``) with fresh noise."""
    rng = np.random.default_rng(mix["base_seed"])
    p, o = mix["prompt"], mix["output"]
    plen = np.clip(rng.lognormal(_mu(p), p["sigma"], size=n),
                   p["min"], p["max"]).astype(int)
    z = (np.log(plen) - np.mean(np.log(plen))) / (np.std(np.log(plen))
                                                   + 1e-9)
    eps = rng.normal(size=n)
    corr = o.get("corr", 0.0)
    latent = corr * z + math.sqrt(1 - corr ** 2) * eps
    out = np.clip(np.exp(_mu(o) + o["sigma"] * latent),
                  o["min"], o["max"]).astype(int)
    return plen, out


def shuffle_blocks(n: int, block: int, rng) -> np.ndarray:
    """A permutation of range(n) that moves each index only within its
    block of ``block`` consecutive ones."""
    return np.concatenate([i + rng.permutation(min(block, n - i))
                           for i in range(0, n, block)])


def stream(mix: dict, n: int, seed: int, *, capacity: int, vocab: int,
           rate: Optional[float] = None) -> List[Item]:
    """``n`` requests in due order. The sizes (and with ``rate`` the
    Poisson gaps, exponential of that mean) are drawn in one order from
    the mix's base seed; the seed reorders each within blocks of
    ``mix["block"]`` consecutive requests, so every stretch of the stream
    holds the same work for every seed. Without ``rate`` every request is
    due at 0 (a closed loop takes them in order). Each prompt is cut so
    that prompt + output fits ``capacity`` slots."""
    plen, out = sizes(mix, n)
    rng = np.random.default_rng(seed)
    order = shuffle_blocks(n, mix["block"], rng)
    plen, out = plen[order], out[order]
    plen = np.maximum(1, np.minimum(plen, capacity - out))
    if rate is not None:
        gaps = np.random.default_rng(mix["base_seed"] + 1).exponential(
            1.0 / rate, size=n)
        due = np.cumsum(gaps[shuffle_blocks(n, mix["block"], rng)])
    else:
        due = np.zeros(n)
    slo = mix["slo"]
    items = []
    for i in range(n):
        items.append(Item(
            due=float(due[i]),
            prompt=rng.integers(0, vocab, size=int(plen[i]), dtype=np.int64),
            out=int(out[i]),
            slo=slo["scale"] * (slo["t_p"] + slo["t_g"] * float(out[i]))))
    return items
