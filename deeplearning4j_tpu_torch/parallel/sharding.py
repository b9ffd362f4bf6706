"""Per-process input sharding (counterpart of
``deeplearning4j_tpu/parallel/sharding.py``; reference
``spark/util/SparkUtils.java:1``, each executor reading its slice).

* :func:`shard_iterator`: every rank walks the SAME global iterator and
  takes its contiguous row slice of each batch; ``ClusterTrainer.fit``
  wraps a global iterator this way, so ranks train on exactly the global
  batch with no row twice.
* :func:`shard_files`: deterministic round-robin assignment of files.

Rank and world come from ``torch.distributed`` when a group is
initialised, else 0 and 1; the assignments are the JAX package's for the
same (index, count).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


class UnequalShardError(ValueError):
    """Process-local batch sizes differ across ranks. Raised before the
    step: unequal shards would make the mean of the ranks' mean losses
    differ from the global batch's mean (and a rank that drops a batch its
    peers train orphans their collective); this error names every rank's
    count and the fix instead."""


def check_equal_local_shards(counts: Sequence[int]) -> None:
    """Validate one all-gathered vector of per-process local batch sizes
    (index = process index). Raises :class:`UnequalShardError` naming the
    offenders — the single definition ClusterTrainer's pre-assembly check
    uses and tests can hit directly."""
    counts = [int(c) for c in counts]
    if len(set(counts)) <= 1:
        return
    per = ", ".join(f"p{i}={c}" for i, c in enumerate(counts))
    raise UnequalShardError(
        f"process-local batch sizes differ across hosts: {per}. Every "
        "host must feed the same local batch size — shard a GLOBAL "
        "iterator with shard_iterator (equal row slices by construction), "
        "or drop/pad ragged tail batches identically on every host "
        "(masked-loss padding via perf.bucketing)")


def _process_defaults(process_index, num_processes):
    if process_index is None or num_processes is None:
        import torch.distributed as dist
        up = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if up else 0
        if num_processes is None:
            num_processes = dist.get_world_size() if up else 1
    if not (0 <= process_index < num_processes):
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"{num_processes} processes")
    return process_index, num_processes


def shard_dataset_rows(ds: DataSet, process_index: Optional[int] = None,
                       num_processes: Optional[int] = None) -> DataSet:
    """This process's contiguous row-slice of a global batch. The process
    count must divide the global batch size (equal shards; no ragged
    per-rank shard)."""
    pi, np_ = _process_defaults(process_index, num_processes)
    n = ds.num_examples()
    if n % np_:
        raise ValueError(
            f"Global batch {n} not divisible by {np_} processes")
    k = n // np_
    sl = slice(pi * k, (pi + 1) * k)

    def cut(a):
        if a is None:
            return None
        return a[sl] if hasattr(a, "is_cuda") else np.asarray(a)[sl]

    return DataSet(cut(ds.features), cut(ds.labels),
                   features_mask=cut(ds.features_mask),
                   labels_mask=cut(ds.labels_mask))


class ShardIterator(DataSetIterator):
    """Re-iterable view of a global iterator yielding this process's row
    shard of every batch (see module docstring)."""

    def __init__(self, base, process_index: Optional[int] = None,
                 num_processes: Optional[int] = None):
        self._base = base
        self._pi = process_index
        self._np = num_processes

    def reset(self):
        if hasattr(self._base, "reset"):
            self._base.reset()

    def _generate(self):
        for ds in self._base:
            yield shard_dataset_rows(ds, self._pi, self._np)

    def batch_size(self):
        pi, np_ = _process_defaults(self._pi, self._np)
        bs = self._base.batch_size() if hasattr(self._base, "batch_size") \
            else 0
        return bs // np_ if bs else 0

    def input_columns(self):
        return self._base.input_columns() \
            if hasattr(self._base, "input_columns") else None

    def total_outcomes(self):
        return self._base.total_outcomes() \
            if hasattr(self._base, "total_outcomes") else None


def shard_iterator(iterator, process_index: Optional[int] = None,
                   num_processes: Optional[int] = None) -> ShardIterator:
    """Wrap a global DataSetIterator (or any iterable of DataSets) so this
    process sees its own row shard of each global batch."""
    return ShardIterator(iterator, process_index, num_processes)


def shard_files(paths: Sequence[str], process_index: Optional[int] = None,
                num_processes: Optional[int] = None,
                sort: bool = True) -> List[str]:
    """Deterministic round-robin assignment of files to this process
    (reference SparkUtils export/repartition reading pattern). Sorting
    first makes the assignment identical on every host regardless of
    listing order."""
    pi, np_ = _process_defaults(process_index, num_processes)
    items = sorted(paths) if sort else list(paths)
    return items[pi::np_]


def shard_directory(path: str, pattern: str = "*",
                    process_index: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[str]:
    """``shard_files`` over a directory glob."""
    import glob as _glob
    return shard_files(_glob.glob(os.path.join(path, pattern)),
                       process_index, num_processes)


__all__ = ["shard_dataset_rows", "shard_iterator", "ShardIterator",
           "shard_files", "shard_directory", "UnequalShardError",
           "check_equal_local_shards"]
