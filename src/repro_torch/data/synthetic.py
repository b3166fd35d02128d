"""Deterministic synthetic image data (numpy), a copy of the reference's
``repro/data/synthetic.py::make_image_dataset`` and
``train_test_split``; the tests pin the copy to the reference bit for
bit.

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
