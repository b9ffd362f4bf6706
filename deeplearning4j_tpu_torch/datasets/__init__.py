"""Datasets of the port: numpy DataSet / MultiDataSet holders."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

__all__ = ["DataSet", "MultiDataSet"]
