"""DataSet / MultiDataSet containers (counterpart of
``deeplearning4j_tpu/datasets/dataset.py``). Features, labels and masks are
numpy arrays or tensors (on the CPU or the card); a network moves each
batch to its device when it trains on it, and takes a tensor already there
as it is. Slicing, shuffling and merging keep tensors tensors, on their
device: nothing passes through numpy."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _take(a, idx: np.ndarray):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def _cat(parts):
    if parts[0] is None:
        return None
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def shuffle(self, rng: np.random.Generator):
        """Permute the examples by ``rng.permutation`` (the JAX package's
        order for the same generator)."""
        idx = rng.permutation(self.num_examples())
        self.features, self.labels, self.features_mask, self.labels_mask = (
            _take(a, idx) for a in (self.features, self.labels, self.features_mask,
                                    self.labels_mask))

    def split(self, batch_size: int):
        n = self.num_examples()
        out = []
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            out.append(DataSet(
                self.features[sl], self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl],
            ))
        return out

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(name):
            return _cat([getattr(d, name) for d in datasets])
        return DataSet(cat("features"), cat("labels"), cat("features_mask"),
                       cat("labels_mask"))


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output dataset (ComputationGraph currency)."""

    features: Sequence[np.ndarray]
    labels: Sequence[np.ndarray]
    features_masks: Optional[Sequence[Optional[np.ndarray]]] = None
    labels_masks: Optional[Sequence[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            [ds.features], [ds.labels],
            [ds.features_mask] if ds.features_mask is not None else None,
            [ds.labels_mask] if ds.labels_mask is not None else None,
        )
