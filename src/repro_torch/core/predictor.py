"""Response-length (RL) prediction (§2.3 / §3.3.2).

The paper fine-tunes OPT-13B à la Zheng et al. [23]; offline we provide:

  * ``OraclePredictor``   — ground truth (the paper's "Oracle" variant).
  * ``NoisyPredictor``    — bucket-accurate with a calibrated probability
    (matched to the paper's 77.5% / 73.2% / 69.8% sweet-spot accuracies),
    lognormal bucket error otherwise. Default for experiments.
  * ``LearnedPredictor``  — a small JAX MLP over prompt features, trained
    with the framework's own optimizer; demonstrates the full pipeline.

All predictors return a *bucketed* RL (multiple of ``bucket``), which is
what makes time-synced same-RL grouping effective (O2).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .request import Request

DEFAULT_BUCKET = 32


def bucketize(rl: float, bucket: int = DEFAULT_BUCKET) -> int:
    return max(bucket, int(math.ceil(rl / bucket)) * bucket)


class OraclePredictor:
    name = "oracle"

    def __init__(self, bucket: int = DEFAULT_BUCKET):
        self.bucket = bucket

    def predict(self, req: Request) -> int:
        return bucketize(req.true_rl, self.bucket)


class NoisyPredictor:
    """Bucket-correct with prob ``accuracy``; otherwise off by a lognormal
    multiplicative factor (under-prediction slightly more likely, matching
    Figure 5a's under/over-provisioning split)."""
    name = "noisy"

    def __init__(self, accuracy: float = 0.75, bucket: int = DEFAULT_BUCKET,
                 seed: int = 0, under_bias: float = 0.10):
        self.accuracy = accuracy
        self.bucket = bucket
        self.under_bias = under_bias
        self.rng = np.random.default_rng(seed)

    def predict(self, req: Request) -> int:
        if self.rng.random() < self.accuracy:
            return bucketize(req.true_rl, self.bucket)
        # miss: multiplicative lognormal error, biased slightly low
        err = self.rng.lognormal(-self.under_bias, 0.35)
        return bucketize(req.true_rl * err, self.bucket)


class LearnedPredictor:
    """Tiny MLP over prompt features. Feature vector: [log prompt_len, 1].

    Trained offline (fit) with plain numpy gradient descent — prediction has
    to be cheap and dependency-free inside the scheduler loop; the JAX
    training path lives in repro_torch.training and is exercised by tests.
    """
    name = "learned"

    def __init__(self, bucket: int = DEFAULT_BUCKET, hidden: int = 16,
                 seed: int = 0):
        self.bucket = bucket
        rng = np.random.default_rng(seed)
        self.w1 = rng.normal(0, 0.5, (2, hidden))
        self.b1 = np.zeros(hidden)
        self.w2 = rng.normal(0, 0.5, (hidden, 1))
        self.b2 = np.zeros(1)

    @staticmethod
    def _features(prompt_lens: np.ndarray) -> np.ndarray:
        x = np.log(np.maximum(prompt_lens, 1.0))
        return np.stack([x, np.ones_like(x)], axis=-1)

    def _forward(self, X):
        h = np.tanh(X @ self.w1 + self.b1)
        return h, (h @ self.w2 + self.b2)[:, 0]

    def fit(self, requests: Sequence[Request], epochs: int = 300,
            lr: float = 0.05) -> float:
        X = self._features(np.array([r.prompt_len for r in requests], float))
        y = np.log(np.array([r.true_rl for r in requests], float))
        for _ in range(epochs):
            h, pred = self._forward(X)
            err = pred - y                       # (N,)
            g2 = h.T @ err / len(y)
            gb2 = err.mean()
            dh = np.outer(err, self.w2[:, 0]) * (1 - h * h)
            g1 = X.T @ dh / len(y)
            gb1 = dh.mean(axis=0)
            self.w2 -= lr * g2[:, None]
            self.b2 -= lr * gb2
            self.w1 -= lr * g1
            self.b1 -= lr * gb1
        _, pred = self._forward(X)
        return float(np.mean((pred - y) ** 2))

    def predict(self, req: Request) -> int:
        X = self._features(np.array([req.prompt_len], float))
        _, pred = self._forward(X)
        return bucketize(float(np.exp(pred[0])), self.bucket)


def apply_padding(predicted: int, pad_ratio: float,
                  bucket: int = DEFAULT_BUCKET) -> int:
    """Sweet-spot padding (O4): allocate predicted * (1 + pad_ratio)."""
    return bucketize(predicted * (1.0 + pad_ratio), bucket)


def annotate(requests: Sequence[Request], predictor, pad_ratio: float,
             bucket: int = DEFAULT_BUCKET) -> None:
    for r in requests:
        r.predicted_rl = predictor.predict(r)
        r.padded_rl = apply_padding(r.predicted_rl, pad_ratio, bucket)
