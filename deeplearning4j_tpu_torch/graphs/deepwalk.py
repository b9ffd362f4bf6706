"""DeepWalk vertex embeddings.

Parity surface: reference
``deeplearning4j-graph/.../models/deepwalk/DeepWalk.java:31`` (builder:
vectorSize, windowSize, learningRate; fit(IGraph, walkLength) with uniform
random walks; GraphVectors API: getVertexVector, similarity) and
``iterator/RandomWalkIterator.java`` (NO_EDGE_HANDLING=SELF_LOOP_ON_DISCONNECTED).

Counterpart of ``deeplearning4j_tpu/graphs/deepwalk.py``. Instead of the
reference's per-pair hierarchical-softmax GraphHuffman SGD on the host,
walks are lowered to token sequences and trained with the port's
SequenceVectors (SGNS/HS steps on the model's device, their table updates
through the ``scatter_add`` kernel) — one engine for word, document and
graph embeddings. The walks are numpy draws, the JAX package's for the
same seed. ``fit`` trains on ``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graphs.graph import Graph
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors


def _weighted_cdf(weights) -> np.ndarray:
    """The cdf ``Generator.choice(a, p=w / w.sum())`` searches: ``p``'s
    cumulative sum divided by its last entry, as numpy computes it."""
    w = np.asarray(weights, np.float64)
    cdf = (w / w.sum()).cumsum()
    cdf /= cdf[-1]
    return cdf


class _Uniforms:
    """``Generator.random()`` one double at a time, drawn in blocks: the
    same doubles in the same order (a block is the next doubles of the
    stream), for a generator nothing else draws from afterwards."""

    def __init__(self, rng, block: int = 4096):
        self.rng, self.block = rng, block
        self.buf, self.pos = [], 0

    def next(self) -> float:
        if self.pos == len(self.buf):
            self.buf, self.pos = self.rng.random(self.block).tolist(), 0
        self.pos += 1
        return self.buf[self.pos - 1]


def _draw(uniforms: _Uniforms, cdf: np.ndarray) -> int:
    """``Generator.choice(len(cdf), p=...)`` for a precomputed cdf: the one
    uniform double the call draws, searched in the cdf, so the stream and
    the index are the call's own at a fraction of its per-call checks."""
    return int(cdf.searchsorted(uniforms.next(), side="right"))


class RandomWalkIterator:
    """Uniform random walks, one starting at every vertex per epoch
    (reference RandomWalkIterator.java); disconnected vertices self-loop.

    The JAX package's walks, draw for draw: a permutation of the vertices
    from ``default_rng(seed + epoch)``, then per step ``integers(0,
    degree)`` (uniform) or one ``choice`` by edge weight (weighted), here
    with the neighbour lists and weight cdfs looked up once per epoch."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 weighted: bool = False):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.weighted = weighted

    def walks(self, epoch: int = 0) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.graph.num_vertices)
        adj = [self.graph.connected_vertices(v) for v in range(self.graph.num_vertices)]
        cdfs = ([_weighted_cdf(self.graph.edge_weights(v)) if nbrs else None
                 for v, nbrs in enumerate(adj)] if self.weighted else None)
        integers = rng.integers
        uniforms = _Uniforms(rng) if self.weighted else None
        steps = range(self.walk_length - 1)
        out = []
        for start in order:
            v = int(start)
            walk = [v]
            for _ in steps:
                nbrs = adj[v]
                if not nbrs:
                    walk.append(v)  # SELF_LOOP_ON_DISCONNECTED
                    continue
                if cdfs is not None:
                    v = nbrs[_draw(uniforms, cdfs[v])]
                else:
                    v = nbrs[integers(0, len(nbrs))]
                walk.append(v)
            out.append(walk)
        return out


class DeepWalk:
    """Vertex embeddings from truncated random walks + skip-gram."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 1, negative: int = 5,
                 epochs: int = 1, batch_size: int = 2048, seed: int = 123,
                 device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.negative = negative
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = device
        self._vectors: Optional[SequenceVectors] = None
        self.num_vertices = 0

    def _make_walk_iterator(self, graph: Graph, walk_length: int):
        """Hook for subclasses with different transition rules (Node2Vec)."""
        return RandomWalkIterator(graph, walk_length, seed=self.seed)

    def fit(self, graph: Graph, walk_length: Optional[int] = None) -> "DeepWalk":
        """Generate walks and train (reference DeepWalk.fit(IGraph, int))."""
        L = walk_length or self.walk_length
        it = self._make_walk_iterator(graph, L)
        sequences: List[List[str]] = []
        for rep in range(self.walks_per_vertex):
            sequences.extend([[str(v) for v in walk] for walk in it.walks(rep)])
        self._vectors = SequenceVectors(
            layer_size=self.vector_size, window_size=self.window_size,
            learning_rate=self.learning_rate, negative=self.negative,
            epochs=self.epochs, batch_size=self.batch_size,
            min_word_frequency=1, sampling=0.0, seed=self.seed,
            device=self.device)
        self._vectors.fit(sequences)
        self.num_vertices = graph.num_vertices
        return self

    # ------------------------------------------------- GraphVectors surface
    def get_vertex_vector(self, vertex: int) -> np.ndarray:
        vec = self._vectors.word_vector(str(vertex))
        if vec is None:
            raise ValueError(f"Vertex {vertex} not in the trained model")
        return vec

    def similarity(self, a: int, b: int) -> float:
        return self._vectors.similarity(str(a), str(b))

    def verts_nearest(self, vertex: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in
                self._vectors.words_nearest(str(vertex), top_n)]
