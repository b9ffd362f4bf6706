"""Batch-size bucketing (counterpart of ``deeplearning4j_tpu/perf/bucketing.py``:
``BucketPolicy`` with ``buckets_up_to`` and ``from_histogram``,
``pad_to_bucket``, ``unpad``).

On XLA every new batch shape is a compile; PyTorch runs eagerly, so the
ladder's job here is to hand the kernels a small set of batch sizes (a
later CUDA-graph capture needs exactly that). The rows added by padding are
zeros and are sliced off after the forward.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch


class BucketPolicy:
    """Round batch sizes up to a canonical bucket: the next power of two,
    clamped to ``[floor, cap]`` (sizes above ``cap`` round up to a multiple
    of ``cap``), or the smallest entry of an explicit ``buckets`` list
    (sizes above its largest round up to a multiple of it)."""

    def __init__(self, floor: int = 8, cap: int = 1024,
                 buckets: Optional[Sequence[int]] = None):
        if floor < 1:
            raise ValueError(f"floor must be >= 1, got {floor}")
        if cap < floor:
            raise ValueError(f"cap {cap} must be >= floor {floor}")
        self.floor = int(floor)
        self.cap = int(cap)
        self._explicit: Optional[List[int]] = (
            sorted(int(b) for b in buckets) if buckets else None)
        if self._explicit and self._explicit[0] < 1:
            raise ValueError("explicit buckets must be positive")

    def bucket(self, n: int) -> int:
        """Smallest bucket >= n."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        if self._explicit is not None:
            for b in self._explicit:
                if n <= b:
                    return b
            top = self._explicit[-1]
            return -(-n // top) * top
        if n <= self.floor:
            return self.floor
        if n > self.cap:
            return -(-n // self.cap) * self.cap
        return min(1 << (int(n) - 1).bit_length(), self.cap)

    def buckets_up_to(self, n: int) -> List[int]:
        """All distinct buckets that sizes 1..n can map to (the warmup set)."""
        out, b = [], 1
        while b < n:
            bb = self.bucket(b)
            out.append(bb)
            b = bb + 1
        if not out or out[-1] < self.bucket(n):
            out.append(self.bucket(n))
        return out

    @classmethod
    def from_histogram(cls, batch_sizes: Iterable[int],
                       max_compiles: int = 8) -> "BucketPolicy":
        """Learn an explicit ladder from OBSERVED batch sizes (the pre-pad
        row counts ``ParallelInference`` records): at most ``max_compiles``
        buckets minimising ``sum_s count(s) * bucket(s)``, the padded rows
        a dispatch pays for, by a contiguous-partition DP over the distinct
        sizes — the JAX package's ladder for the same histogram."""
        hist = Counter(int(s) for s in batch_sizes)
        if any(s < 1 for s in hist):
            raise ValueError("batch sizes must be >= 1")
        if not hist:
            raise ValueError("empty batch-size histogram")
        if max_compiles < 1:
            raise ValueError(f"max_compiles must be >= 1, got {max_compiles}")
        vals = sorted(hist)
        cnts = [hist[v] for v in vals]
        n = len(vals)
        K = min(int(max_compiles), n)
        pref = [0] * (n + 1)
        for i, c in enumerate(cnts):
            pref[i + 1] = pref[i] + c
        # best[k][j]: least cost covering sizes[0..j] with k buckets, the
        # k-th sitting at vals[j]
        inf = float("inf")
        best = [[inf] * n for _ in range(K + 1)]
        back = [[-1] * n for _ in range(K + 1)]
        for j in range(n):
            best[1][j] = vals[j] * pref[j + 1]
        for k in range(2, K + 1):
            for j in range(k - 1, n):
                for i in range(k - 2, j):
                    c = best[k - 1][i] + vals[j] * (pref[j + 1] - pref[i + 1])
                    if c < best[k][j]:
                        best[k][j] = c
                        back[k][j] = i
        k = min(range(1, K + 1), key=lambda kk: (best[kk][n - 1], kk))
        buckets, j = [], n - 1
        while k >= 1:
            buckets.append(vals[j])
            j = back[k][j]
            k -= 1
        return cls(buckets=sorted(buckets))

    def __repr__(self):
        if self._explicit is not None:
            return f"BucketPolicy(buckets={self._explicit})"
        return f"BucketPolicy(floor={self.floor}, cap={self.cap})"


def pad_to_bucket(t, target: int, dim: int = 0):
    """Zero-pad ``t`` (a tensor, or a numpy array, which stays on the host)
    along ``dim`` to ``target`` rows (no-op if equal)."""
    n = t.shape[dim]
    if n == target:
        return t
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    shape = list(t.shape)
    shape[dim] = target - n
    if isinstance(t, np.ndarray):
        return np.concatenate([t, np.zeros(shape, t.dtype)], axis=dim)
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def unpad(t, n: int, dim: int = 0):
    """The first ``n`` rows of a bucket-padded tensor or array."""
    if t.shape[dim] == n:
        return t
    sl = [slice(None)] * t.ndim
    sl[dim] = slice(0, n)
    return t[tuple(sl)]
