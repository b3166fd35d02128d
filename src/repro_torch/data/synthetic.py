"""Deterministic synthetic data (numpy), a copy of the reference's
``repro/data/synthetic.py::make_image_dataset``,
``make_token_lm_dataset`` and ``train_test_split``; the tests pin the
copy to the reference bit for bit.

Images: class-conditional frequency templates plus per-sample Gaussian
noise, so the classes are learnable and FL training dynamics mean
something (the offline stand-in for MNIST/FEMNIST and CIFAR).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_image_dataset(
    n: int,
    classes: int,
    size: int = 32,
    channels: int = 3,
    noise: float = 0.6,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """``{"x": (n, size, size, channels) fp32, "y": (n,) int32}``."""
    rng = np.random.RandomState(seed)
    # class templates: superpositions of random low-frequency waves
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    templates = np.zeros((classes, size, size, channels), np.float32)
    for c in range(classes):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, channels)
            amp = rng.uniform(0.5, 1.0)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) / size)[..., None] + np.cos(ph)
            templates[c] += amp * wave.astype(np.float32)
    templates /= np.abs(templates).max(axis=(1, 2, 3), keepdims=True)
    y = rng.randint(0, classes, n).astype(np.int32)
    x = templates[y] + noise * rng.randn(n, size, size, channels).astype(np.float32)
    return {"x": x.astype(np.float32), "y": y}


def make_token_lm_dataset(n_seq: int, seq_len: int, vocab: int,
                          seed: int = 0) -> np.ndarray:
    """(n_seq, seq_len) int32 token streams for LM smoke training:
    Zipfian unigrams plus local repeat structure (with probability 0.3
    token t equals token t-4), so cross-entropy can fall well below
    ln(V)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab, size=(n_seq, seq_len), p=probs).astype(np.int32)
    mask = rng.rand(n_seq, seq_len) < 0.3
    for t in range(4, seq_len):
        base[:, t] = np.where(mask[:, t], base[:, t - 4], base[:, t])
    return base


def train_test_split(data: Dict[str, np.ndarray], test_frac: float = 0.1,
                     seed: int = 0) -> Tuple[Dict, Dict]:
    """A seeded permutation split into (train, test) dicts."""
    n = len(data["y"]) if "y" in data else len(next(iter(data.values())))
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr = {k: v[idx[:cut]] for k, v in data.items()}
    te = {k: v[idx[cut:]] for k, v in data.items()}
    return tr, te
