"""Clustering (counterpart of ``deeplearning4j_tpu/clustering/``): K-Means,
the coarse quantizer and the PQ codebook trainer of ``retrieval/``, on the
model's device; and the exact nearest-neighbour structures, host code as in
the JAX package: ``VPTree``, ``KDTree`` and ``NearestNeighborsServer``
(k-NN over HTTP from a VPTree)."""

from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer

__all__ = ["VPTree", "KDTree", "KMeansClustering", "NearestNeighborsServer"]
