"""Datasets of the port: DataSet / MultiDataSet holders and the generated
``synthetic_mnist``."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_mnist

__all__ = ["DataSet", "MultiDataSet", "synthetic_mnist"]
