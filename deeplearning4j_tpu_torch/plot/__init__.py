"""Dimensionality reduction / visualization (counterpart of
``deeplearning4j_tpu/plot/``).

Parity surface: reference ``deeplearning4j-core/.../plot/BarnesHutTsne.java``.
"""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne

__all__ = ["BarnesHutTsne", "Tsne"]
