"""Seeded weights in the port's parameter layout, made by the benchmark.

The names and shapes come from the port's ``model.param_tree``; the values
do not: every random leaf is a view into one flat buffer in the served
dtype, filled by a ``torch.Generator`` on the run's device in slices of
2**30 values and then scaled in place. A matrix (a stack of them, (..., d_in,
d_out)) has std 1/sqrt(d_in); the embedding table std 1; norm scales are
ones. The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

FILL = 1 << 30


def _std(name: str, shape) -> float:
    if name == "tok_embed":
        return 1.0
    return 1.0 / math.sqrt(shape[-2])


def make_params(cfg, seed: int, device, dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    from repro_torch.models import model
    tree = model.param_tree(cfg)
    rand = [(n, m.shape) for n, m in sorted(tree.items())
            if m.init not in ("ones", "zeros")]
    total = sum(math.prod(s) for _, s in rand)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device)
    for part in flat.split(FILL):
        part.normal_(generator=gen)
    params, off = {}, 0
    for n, shape in rand:
        k = math.prod(shape)
        params[n] = flat[off:off + k].view(shape).mul_(_std(n, shape))
        off += k
    for n, m in tree.items():
        if n not in params:
            fill = torch.ones if m.init == "ones" else torch.zeros
            params[n] = fill(m.shape, dtype=dtype, device=device)
    return params
