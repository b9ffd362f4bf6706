"""Node2Vec vertex embeddings.

Parity surface: reference
``deeplearning4j-nlp/.../models/node2vec/Node2Vec.java:34`` (p/q-biased
second-order random walks feeding the SequenceVectors machinery; Grover &
Leskovec 2016).

Counterpart of ``deeplearning4j_tpu/graphs/node2vec.py``. Like DeepWalk,
the walks lower to token sequences trained through the port's
SequenceVectors; only the walk generator differs — the
return parameter ``p`` (likelihood of revisiting the previous vertex) and
in-out parameter ``q`` (BFS- vs DFS-like exploration) bias each transition:

  alpha = 1/p if next == prev; 1 if next is a neighbour of prev; else 1/q
"""

from __future__ import annotations

from typing import List

import numpy as np

from deeplearning4j_tpu_torch.graphs.deepwalk import DeepWalk, _Uniforms, _draw, _weighted_cdf
from deeplearning4j_tpu_torch.graphs.graph import Graph


class Node2VecWalkIterator:
    """Second-order biased walks, one starting at every vertex per epoch.
    Disconnected vertices self-loop (same NO_EDGE_HANDLING as DeepWalk).

    The JAX package's walks, draw for draw: each step one ``choice`` over
    the neighbours with probabilities ``w * alpha / sum``, here as the
    same cdf searched with the same uniform draw (``deepwalk._draw``)."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 123, weighted: bool = False):
        self.graph = graph
        self.walk_length = walk_length
        self.p = float(p)
        self.q = float(q)
        self.seed = seed
        self.weighted = weighted

    def walks(self, epoch: int = 0) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.graph.num_vertices)
        adj = [self.graph.connected_vertices(v) for v in range(self.graph.num_vertices)]
        weights = ([np.asarray(self.graph.edge_weights(v), np.float64) for v in range(len(adj))]
                   if self.weighted else None)
        first = [_weighted_cdf(weights[v] if self.weighted else np.ones(len(nbrs)))
                 if nbrs else None for v, nbrs in enumerate(adj)]
        # each vertex's neighbours as an array, and their sorted distinct
        # ids for the "is a neighbour of prev" test by binary search
        arrs = [np.asarray(nbrs, np.int64) for nbrs in adj]
        sets = [np.unique(a) for a in arrs]
        uniforms = _Uniforms(rng)
        back, away = 1.0 / self.p, 1.0 / self.q
        out = []
        for start in order:
            v = int(start)
            walk = [v]
            prev = None
            for _ in range(self.walk_length - 1):
                nbrs = adj[v]
                if not nbrs:
                    walk.append(v)  # SELF_LOOP_ON_DISCONNECTED
                    prev = v
                    continue
                if prev is None:
                    cdf = first[v]
                else:
                    # 1/p back to prev, 1 to a neighbour of prev, 1/q away
                    arr, known = arrs[v], sets[prev]
                    found = known[np.minimum(known.searchsorted(arr), len(known) - 1)] == arr
                    alpha = np.where(arr == prev, back, np.where(found, 1.0, away))
                    # unweighted, w * alpha is alpha exactly (w is all ones)
                    cdf = _weighted_cdf(weights[v] * alpha if self.weighted else alpha)
                nxt = nbrs[_draw(uniforms, cdf)]
                walk.append(nxt)
                prev, v = v, nxt
            out.append(walk)
        return out


class Node2Vec(DeepWalk):
    """DeepWalk with p/q-biased transitions (reference Node2Vec.java:34;
    p=q=1 reduces exactly to DeepWalk's uniform walks)."""

    def __init__(self, p: float = 1.0, q: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.p = p
        self.q = q

    def _make_walk_iterator(self, graph: Graph, walk_length: int):
        return Node2VecWalkIterator(graph, walk_length, p=self.p, q=self.q,
                                    seed=self.seed)
