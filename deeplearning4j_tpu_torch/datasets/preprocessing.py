"""DataSet pre-processors / normalizers (counterpart of
``deeplearning4j_tpu/datasets/preprocessing.py``; host-side numpy, the
JAX package's arithmetic).

Parity surface: ND4J's ``DataSetPreProcessor`` + normalizers
(NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler —
the objects passed to ``DataSetIterator.setPreProcessor`` throughout the
reference, e.g. RecordReaderDataSetIterator.java setPreProcessor).

Pre-processors are callables ``DataSet -> DataSet`` (pure, not in-place —
functional style keeps them safe under async prefetch where the same source
batch may be referenced elsewhere). Normalizers additionally have
``fit(iterator_or_dataset)`` to learn statistics and ``revert_*`` inverses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetPreProcessor:
    def __call__(self, ds: DataSet) -> DataSet:
        return self.pre_process(ds)

    def pre_process(self, ds: DataSet) -> DataSet:
        raise NotImplementedError


def _feature_axes(x: np.ndarray):
    # statistics per trailing feature dim; (n, f), (n, t, f) and (n, h, w, c)
    # all reduce over every axis but the last
    return tuple(range(x.ndim - 1))


class NormalizerStandardize(DataSetPreProcessor):
    """Zero-mean unit-variance feature scaling (ND4J NormalizerStandardize)."""

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None

    def fit(self, data):
        if isinstance(data, DataSet):
            data = [data]
        xs, ys = [], []
        for ds in data:
            xs.append(np.asarray(ds.features, np.float64)
                      .reshape(-1, ds.features.shape[-1]))
            if self.fit_labels:
                ys.append(np.asarray(ds.labels, np.float64)
                          .reshape(-1, ds.labels.shape[-1]))
        x = np.concatenate(xs)
        self.mean = x.mean(0)
        self.std = np.maximum(x.std(0), 1e-8)
        if self.fit_labels:
            y = np.concatenate(ys)
            self.label_mean = y.mean(0)
            self.label_std = np.maximum(y.std(0), 1e-8)
        return self

    def pre_process(self, ds: DataSet) -> DataSet:
        if self.mean is None:
            raise ValueError("fit() the normalizer before use")
        x = ((ds.features - self.mean) / self.std).astype(np.float32)
        y = ds.labels
        if self.fit_labels and self.label_mean is not None:
            y = ((y - self.label_mean) / self.label_std).astype(np.float32)
        return DataSet(x, y, ds.features_mask, ds.labels_mask)

    def revert_features(self, x: np.ndarray) -> np.ndarray:
        return x * self.std + self.mean

    def revert_labels(self, y: np.ndarray) -> np.ndarray:
        if self.label_mean is None:
            return y
        return y * self.label_std + self.label_mean


class NormalizerMinMaxScaler(DataSetPreProcessor):
    """Scale features into [lo, hi] (ND4J NormalizerMinMaxScaler)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi
        self.min: Optional[np.ndarray] = None
        self.max: Optional[np.ndarray] = None

    def fit(self, data):
        if isinstance(data, DataSet):
            data = [data]
        mins, maxs = [], []
        for ds in data:
            x = np.asarray(ds.features).reshape(-1, ds.features.shape[-1])
            mins.append(x.min(0))
            maxs.append(x.max(0))
        self.min = np.min(mins, axis=0)
        self.max = np.max(maxs, axis=0)
        return self

    def pre_process(self, ds: DataSet) -> DataSet:
        if self.min is None:
            raise ValueError("fit() the normalizer before use")
        rng = np.maximum(self.max - self.min, 1e-12)
        x = (ds.features - self.min) / rng * (self.hi - self.lo) + self.lo
        return DataSet(x.astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)


class ImagePreProcessingScaler(DataSetPreProcessor):
    """uint8-range pixels → [lo, hi] without fitting (ND4J
    ImagePreProcessingScaler): x/255 * (hi-lo) + lo."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0, max_pixel: float = 255.0):
        self.lo, self.hi, self.max_pixel = lo, hi, max_pixel

    def pre_process(self, ds: DataSet) -> DataSet:
        x = ds.features / self.max_pixel * (self.hi - self.lo) + self.lo
        return DataSet(x.astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)


class CombinedPreProcessor(DataSetPreProcessor):
    """Chain pre-processors in order (reference CombinedPreProcessor.java)."""

    def __init__(self, *processors: DataSetPreProcessor):
        self.processors = processors

    def pre_process(self, ds: DataSet) -> DataSet:
        for p in self.processors:
            ds = p(ds)
        return ds
