"""Graph vertex embeddings.

Parity surface: reference ``deeplearning4j-graph/`` —
``graph/Graph.java`` (adjacency-list IGraph), ``iterator/RandomWalkIterator.java``,
``models/deepwalk/DeepWalk.java:31`` (+ GraphVectors lookup API).
"""

from deeplearning4j_tpu_torch.graphs.graph import Graph
from deeplearning4j_tpu_torch.graphs.deepwalk import DeepWalk, RandomWalkIterator
from deeplearning4j_tpu_torch.graphs.node2vec import Node2Vec, Node2VecWalkIterator

__all__ = ["Graph", "DeepWalk", "RandomWalkIterator", "Node2Vec",
           "Node2VecWalkIterator"]
