"""K-Means clustering with Lloyd iterations on the tensor's device
(counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``).

The k-means++ seeding is host numpy, step for step the JAX package's (the
same ``default_rng(seed)`` draws), so a seeded run starts from the same
centroids in both packages. Each Lloyd step is a few tensor ops: full
float32 squared distances in the expanded form (the ``x @ c.T`` product
with TF32 off, ``device.resolve_device`` sees to that), ``argmin`` (first
index on ties, as ``jnp.argmin``), and the centroid sums as a one-hot
matrix product. No ``index_add_``: its CUDA atomics add in no fixed order,
and two builds of one index must agree.

``check_every`` steps run between host reads of the centroid shift. Inside
such a chunk a device-side flag freezes the centroids after the first step
whose shift falls under ``tol``, which is the JAX ``lax.while_loop``'s
stopping rule, so the iteration sequence and the stop point are the JAX
package's with one host read per chunk.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["KMeansClustering"]


def _lloyd_step(points: torch.Tensor, centroids: torch.Tensor, k: int):
    """One Lloyd iteration: ``(new_centroids, assign, shift, cost)``."""
    d2 = ((points ** 2).sum(1, keepdim=True)
          - 2.0 * (points @ centroids.T)
          + (centroids ** 2).sum(1))
    assign = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    counts = onehot.sum(0)
    sums = onehot.T @ points
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp_min(counts[:, None], 1.0),
                                centroids)  # keep empty clusters in place
    shift = ((new_centroids - centroids) ** 2).sum()
    cost = d2.min(dim=1).values.sum()
    return new_centroids, assign, shift, cost


class KMeansClustering:
    """Lloyd's algorithm with k-means++ seeding. ``device`` follows the
    port's device rule: ``cuda`` unless the caller passes ``device="cpu"``."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 123, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: np.ndarray = None
        self.cost: float = float("nan")

    @staticmethod
    def setup(k: int, max_iterations: int = 100,
              distance: str = "euclidean", device=None) -> "KMeansClustering":
        """Reference factory signature (KMeansClustering.setup)."""
        if distance != "euclidean":
            raise ValueError("Only euclidean K-Means is supported")
        return KMeansClustering(k, max_iterations, device=device)

    def _seed_centroids(self, x: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        first = int(rng.integers(0, len(x)))
        chosen = [first]
        d2 = np.sum((x - x[first]) ** 2, axis=1)
        for _ in range(1, self.k):
            total = d2.sum()
            if total <= 1e-12:
                # fewer distinct points than k: every point already coincides
                # with a chosen seed — fall back to uniform draws
                nxt = int(rng.integers(0, len(x)))
            else:
                nxt = int(rng.choice(len(x), p=d2 / total))
            chosen.append(nxt)
            d2 = np.minimum(d2, np.sum((x - x[nxt]) ** 2, axis=1))
        return x[chosen].copy()

    def apply_to(self, points,
                 check_every: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """Cluster; returns (assignments (n,), centroids (k, d)) as numpy."""
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1; got {check_every}")
        x32 = np.asarray(points, np.float32)
        if not np.isfinite(x32).all():
            raise ValueError("K-Means input contains non-finite values")
        x = torch.from_numpy(np.ascontiguousarray(x32)).to(self.device)
        centroids = torch.from_numpy(self._seed_centroids(x32)).to(self.device)
        done = 0
        self.iterations_run = 0
        while done < self.max_iterations:
            steps = min(int(check_every), self.max_iterations - done)
            active = torch.ones((), dtype=torch.bool, device=self.device)
            ran = torch.zeros((), dtype=torch.int64, device=self.device)
            shift = torch.full((), float("inf"), device=self.device)
            for _ in range(steps):
                new, _, new_shift, _ = _lloyd_step(x, centroids, self.k)
                centroids = torch.where(active, new, centroids)
                shift = torch.where(active, new_shift, shift)
                ran += active.to(torch.int64)
                active = active & (shift >= self.tol)
            self.iterations_run += int(ran)
            done += steps
            if float(shift) < self.tol:
                break
        # final assignment pass against the FINAL centroids so the returned
        # (assign, centroids, cost) triple is mutually consistent
        _, assign, _, cost = _lloyd_step(x, centroids, self.k)
        self.centroids = centroids.cpu().numpy()
        self.cost = float(cost)
        return assign.cpu().numpy(), self.centroids
