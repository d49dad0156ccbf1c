"""Token sampling for the serving engine.

Per-row temperature and top-k with an explicit ``torch.Generator``. The
generator's numbers differ from JAX's threefry, so only greedy rows match
the reference token for token; sampled rows match it in support (every
token lies in its row's top-k set). Categorical draws use the Gumbel-max
trick, which needs no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 → greedy
    top_k: int = 0                # 0 → disabled
    max_new_tokens: int = 64
    eos_token: Optional[int] = None


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def sample_in_graph(logits: torch.Tensor, gen: torch.Generator,
                    temps: torch.Tensor, top_ks: torch.Tensor,
                    need_sample: bool, need_topk: bool) -> torch.Tensor:
    """Per-row temperature / top-k over (B, V) logits. ``need_sample`` and
    ``need_topk`` are host bools: an all-greedy batch is a bare argmax and
    draws nothing from ``gen``; the vocab sort only runs when some row
    uses top-k. The top-k threshold is the reference's: the k-th largest
    scaled logit, ties kept."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not need_sample:
        return greedy
    scaled = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    if need_topk:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        kth_idx = (torch.clamp(top_ks.long(), 1, V) - 1)[:, None]
        kth = torch.gather(srt, -1, kth_idx)
        scaled = torch.where((top_ks[:, None] > 0) & (scaled < kth),
                             torch.full_like(scaled, -1e30), scaled)
    sampled = _categorical(scaled, gen)
    return torch.where(temps > 0.0, sampled, greedy)


def sample_per_request(logits: torch.Tensor, gen: torch.Generator,
                       temps, top_ks) -> torch.Tensor:
    """Batched sampling with per-row temperature and top-k; ``temps`` and
    ``top_ks`` are host arrays (numpy), so the static flags cost no sync."""
    temps = np.asarray(temps, np.float32)
    top_ks = np.asarray(top_ks, np.int32)
    need_sample = bool(np.any(temps > 0.0))
    need_topk = need_sample and bool(np.any(top_ks > 0))
    dev = logits.device
    return sample_in_graph(logits, gen, torch.from_numpy(temps).to(dev),
                           torch.from_numpy(top_ks).to(dev), need_sample,
                           need_topk)
