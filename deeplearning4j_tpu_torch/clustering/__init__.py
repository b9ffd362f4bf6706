"""Clustering (counterpart of ``deeplearning4j_tpu/clustering/``): K-Means,
the coarse quantizer and the PQ codebook trainer of ``retrieval/``."""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering

__all__ = ["KMeansClustering"]
