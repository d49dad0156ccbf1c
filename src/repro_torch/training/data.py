"""Synthetic token data pipeline (deterministic, seedable, sharded-friendly).

A Zipf-ish unigram stream with short-range structure — enough signal for
"loss decreases" integration tests and throughput benchmarking without any
external dataset.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    frontend_tokens: int = 0     # VLM/audio: embeddings supplied separately
    d_model: int = 0


class SyntheticDataset:
    """Markov-flavored token stream: next token depends on the previous one
    through a fixed random permutation with noise — learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.perm = rng.permutation(v)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks ** 1.1)
        self.unigram /= self.unigram.sum()

    def batches(self, seed: Optional[int] = None) -> Iterator[Dict]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed if seed is None else seed)
        while True:
            B, S = cfg.batch_size, cfg.seq_len
            toks = np.empty((B, S), np.int32)
            toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self.unigram)
            noise = rng.random((B, S))
            rand = rng.choice(cfg.vocab_size, size=(B, S), p=self.unigram)
            for t in range(1, S):
                follow = self.perm[toks[:, t - 1]]
                toks[:, t] = np.where(noise[:, t] < 0.75, follow,
                                      rand[:, t])
            out = {"tokens": toks}
            if cfg.frontend_tokens:
                out["embeds"] = rng.standard_normal(
                    (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32) * 0.02
            yield out
