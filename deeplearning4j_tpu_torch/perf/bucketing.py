"""Batch-size bucketing (counterpart of ``deeplearning4j_tpu/perf/bucketing.py``:
``BucketPolicy`` with ``buckets_up_to`` and ``from_histogram``,
``pad_to_bucket``, ``unpad``, and for training ``pad_dataset``,
``pad_multi_dataset``, ``BucketPadDataSetIterator`` and
``RebatchDataSetIterator``, which ``fit(bucket_policy=)`` and
``fit_fused(bucket_policy=)`` use).

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

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


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


def _ones_like_mask(mask_row_shape, n_real: int, target: int, ref):
    """(target, *mask_row_shape) float32 mask, 1 for real rows and 0 for
    the padding, held as ``ref`` is: a numpy array, or a tensor on
    ``ref``'s device."""
    m = np.zeros((target,) + tuple(mask_row_shape), np.float32)
    m[:n_real] = 1.0
    return torch.from_numpy(m).to(ref.device) if isinstance(ref, torch.Tensor) else m


def _pad_mask_rows(mask, target: int, n: int, fill: float):
    if isinstance(mask, torch.Tensor):
        m = mask.to(torch.float32)
        pad = m.new_full((target - n,) + tuple(m.shape[1:]), fill)
        return torch.cat([m, pad])
    m = np.asarray(mask, np.float32)
    pad = np.full((target - n,) + m.shape[1:], fill, np.float32)
    return np.concatenate([m, pad])


def pad_dataset(ds: DataSet, target: int, ensure_lmask: bool = False) -> DataSet:
    """Pad a training DataSet to ``target`` examples, masking the padded
    rows out of the loss (the JAX package's ``pad_dataset``):

    - features and labels zero-pad;
    - ``labels_mask`` gains zero rows; when absent it is made from the
      features mask (sequence labels) or as ones over the real rows, (batch,)
      for 2-D labels or (batch, T) for 3-D ones;
    - ``features_mask`` pads with ONES: all-zero rows of a features mask
      would make masked time pooling divide 0 by 0.

    ``ensure_lmask=True`` attaches the all-ones labels mask even where
    nothing pads, so every batch of an epoch has the same form. Layers that
    couple examples (batch norm in training) see the padded rows in their
    statistics; everything row-independent is exact up to float
    association."""
    n = ds.num_examples()
    if n == target and not (ensure_lmask and ds.labels_mask is None):
        return ds
    feats = pad_to_bucket(ds.features, target)
    labels = pad_to_bucket(ds.labels, target)
    labels_nd = ds.labels.ndim
    if ds.labels_mask is not None:
        lmask = _pad_mask_rows(ds.labels_mask, target, n, 0.0)
    elif ds.features_mask is not None and labels_nd >= 3:
        lmask = _pad_mask_rows(ds.features_mask, target, n, 0.0)
    else:
        row_shape = tuple(ds.labels.shape[1:-1]) if labels_nd >= 3 else ()
        lmask = _ones_like_mask(row_shape, n, target, ds.labels)
    fmask = (None if ds.features_mask is None
             else _pad_mask_rows(ds.features_mask, target, n, 1.0))
    return DataSet(feats, labels, fmask, lmask)


def pad_multi_dataset(mds: MultiDataSet, target: int,
                      ensure_lmask: bool = False) -> MultiDataSet:
    """``pad_dataset`` for the ComputationGraph's MultiDataSet: every input
    and label pads to ``target`` examples and every output gains a labels
    mask. An absent sequence-output mask borrows the features mask only
    when the graph has exactly one; otherwise it is ones over the real
    rows (the JAX package's rule)."""
    n = mds.num_examples()
    k_out = len(mds.labels)
    lmasks = (list(mds.labels_masks) if mds.labels_masks is not None
              else [None] * k_out)
    if n == target and not (ensure_lmask and any(m is None for m in lmasks)):
        return mds
    feats = [pad_to_bucket(f, target) for f in mds.features]
    labels = [pad_to_bucket(y, target) for y in mds.labels]
    fmasks_in = (list(mds.features_masks) if mds.features_masks is not None
                 else [None] * len(mds.features))
    present_fm = [m for m in fmasks_in if m is not None]
    new_lmasks = []
    for y, lm in zip(mds.labels, lmasks):
        if lm is not None:
            new_lmasks.append(_pad_mask_rows(lm, target, n, 0.0))
        elif len(present_fm) == 1 and y.ndim >= 3:
            new_lmasks.append(_pad_mask_rows(present_fm[0], target, n, 0.0))
        else:
            row_shape = tuple(y.shape[1:-1]) if y.ndim >= 3 else ()
            new_lmasks.append(_ones_like_mask(row_shape, n, target, y))
    new_fmasks = None
    if mds.features_masks is not None:
        new_fmasks = [None if m is None else _pad_mask_rows(m, target, n, 1.0)
                      for m in fmasks_in]
    return MultiDataSet(feats, labels, new_fmasks, new_lmasks)


class BucketPadDataSetIterator:
    """Wrap any iterable of DataSets or MultiDataSets so every emitted
    batch lands on a bucket shape (``pad_dataset`` / ``pad_multi_dataset``
    with ``ensure_lmask``). Within one pass a batch smaller than the
    largest size already seen pads up to it, so a ragged final batch takes
    the epoch's shape. Re-iterable iff the base is."""

    def __init__(self, base, policy: Optional[BucketPolicy] = None):
        self._base = base
        self.policy = policy if policy is not None else BucketPolicy()

    def __iter__(self):
        max_seen = 0
        for ds in self._base:
            target = max(self.policy.bucket(ds.num_examples()), max_seen)
            max_seen = max(max_seen, target)
            if isinstance(ds, MultiDataSet):
                yield pad_multi_dataset(ds, target, ensure_lmask=True)
            else:
                yield pad_dataset(ds, target, ensure_lmask=True)

    def reset(self):
        if hasattr(self._base, "reset"):
            self._base.reset()

    def batch_size(self):
        if hasattr(self._base, "batch_size"):
            return self.policy.bucket(self._base.batch_size())
        return None


class RebatchDataSetIterator:
    """Re-slice an iterable of DataSets to exactly ``batch_size`` rows a
    batch, the last one possibly ragged (emitted, not dropped). Example
    order is kept, so the stream is deterministic and resume-safe;
    re-iterable iff the base is."""

    def __init__(self, base, batch_size: int):
        if int(batch_size) <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self._base = base
        self._batch_size = int(batch_size)

    def __iter__(self):
        target = self._batch_size
        buf: List[DataSet] = []
        have = 0
        for ds in self._base:
            n = ds.num_examples()
            if not buf and n == target:
                yield ds
                continue
            buf.append(ds)
            have += n
            if have < target:
                continue
            merged = buf[0] if len(buf) == 1 else DataSet.merge(buf)
            chunks = merged.split(target)
            if chunks[-1].num_examples() < target:
                buf, have = [chunks[-1]], chunks[-1].num_examples()
                chunks = chunks[:-1]
            else:
                buf, have = [], 0
            yield from chunks
        if buf:
            yield buf[0] if len(buf) == 1 else DataSet.merge(buf)

    def reset(self):
        if hasattr(self._base, "reset"):
            self._base.reset()

    def batch_size(self):
        return self._batch_size
