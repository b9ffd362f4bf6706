"""Adjacency-list graph.

Parity surface: reference ``deeplearning4j-graph/.../graph/Graph.java``
(IGraph: numVertices, addEdge directed/undirected, getConnectedVertexIndices)
— host-side structure feeding the random-walk generators.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class Graph:
    def __init__(self, num_vertices: int, allow_multiple_edges: bool = True):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self.num_vertices = num_vertices
        self.allow_multiple_edges = allow_multiple_edges
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(num_vertices)]

    def _check(self, v: int):
        if not 0 <= v < self.num_vertices:
            raise ValueError(f"Vertex {v} out of range [0, {self.num_vertices})")

    def add_edge(self, a: int, b: int, weight: float = 1.0,
                 directed: bool = False):
        self._check(a)
        self._check(b)
        if not self.allow_multiple_edges and any(t == b for t, _ in self._adj[a]):
            return
        self._adj[a].append((b, weight))
        if not directed:
            self._adj[b].append((a, weight))

    def add_edges(self, edges: Sequence[Tuple[int, int]], directed: bool = False):
        for a, b in edges:
            self.add_edge(a, b, directed=directed)

    def connected_vertices(self, v: int) -> List[int]:
        self._check(v)
        return [t for t, _ in self._adj[v]]

    def degree(self, v: int) -> int:
        self._check(v)
        return len(self._adj[v])

    def edge_weights(self, v: int) -> List[float]:
        self._check(v)
        return [w for _, w in self._adj[v]]
