"""Trained-model helpers: canonical input preprocessing for imported models
(counterpart of ``deeplearning4j_tpu/modelimport/trainedmodels.py``).

Parity surface: reference
``keras/trainedmodels/TrainedModels.java:19`` (VGG16 / VGG16NOTOP enum with
``getPreProcessor()``) and ND4J's ``VGG16ImagePreProcessor`` (subtract the
ImageNet channel means, RGB->BGR — the Caffe-heritage VGG convention).
The download URLs of the reference dissolve: weights come from the user's
own Keras .h5 via the importer (zero-egress environment).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.preprocessing import DataSetPreProcessor

# ImageNet channel means in RGB order (VGG16ImagePreProcessor.VGG_MEAN_OFFSET)
VGG_MEAN_RGB = np.array([123.68, 116.779, 103.939], np.float32)


class VGG16ImagePreProcessor(DataSetPreProcessor):
    """0-255 RGB NHWC -> mean-subtracted BGR (ND4J VGG16ImagePreProcessor)."""

    def pre_process(self, ds: DataSet) -> DataSet:
        return DataSet(self.preprocess_features(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    @staticmethod
    def preprocess_features(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32) - VGG_MEAN_RGB
        return x[..., ::-1].copy()  # RGB -> BGR


class TrainedModels:
    """Canonical preprocessing per model family (reference
    TrainedModels.VGG16.getPreProcessor())."""

    VGG16 = "vgg16"
    VGG16NOTOP = "vgg16notop"

    _PRE = {VGG16: VGG16ImagePreProcessor, VGG16NOTOP: VGG16ImagePreProcessor}

    @classmethod
    def get_pre_processor(cls, model: str) -> DataSetPreProcessor:
        key = model.lower()
        if key not in cls._PRE:
            raise ValueError(f"Unknown trained model {model!r}; "
                             f"one of {sorted(cls._PRE)}")
        return cls._PRE[key]()
