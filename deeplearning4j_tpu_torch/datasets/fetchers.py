"""Generated datasets (counterpart of part of
``deeplearning4j_tpu/datasets/fetchers.py``). Nothing is downloaded:
``synthetic_mnist`` is the JAX package's deterministic MNIST-shaped set,
the same numpy draws in the same order, so both packages get the same
arrays from the same seed."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["synthetic_mnist"]


def _one_hot(y: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(y), n), np.float32)
    out[np.arange(len(y)), y] = 1.0
    return out


def synthetic_mnist(num_examples: int, seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 784) float32 in [0, 1] and (n, 10) one-hot labels: uniform noise
    in [0, 0.25], plus 0.7 on an 8x8 patch that the class anchors on a 2x5
    grid; learnable, so LeNet converges on it."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, num_examples)
    x = rng.uniform(0.0, 0.25, (num_examples, 28, 28)).astype(np.float32)
    rows = (y // 5) * 12 + 2
    cols = (y % 5) * 5 + 1
    for i in range(num_examples):
        r, c = rows[i], cols[i]
        x[i, r:r + 8, c:c + 8] += 0.7
    x = np.clip(x, 0.0, 1.0)
    return x.reshape(num_examples, 784), _one_hot(y, 10)
