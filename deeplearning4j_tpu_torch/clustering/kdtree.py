"""k-d tree for axis-aligned euclidean k-NN.

Parity surface: reference ``.../clustering/kdtree/KDTree.java:37`` (insert,
nn search; euclidean). Construction here is bulk median-split (balanced)
rather than incremental insert — same query contract.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index: int, axis: int):
        self.index = index
        self.axis = axis
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, items: np.ndarray):
        self.items = np.asarray(items, np.float64)
        self.dims = self.items.shape[1]
        self._root = self._build(list(range(len(self.items))), 0)

    def _build(self, idx: List[int], depth: int) -> Optional[_KDNode]:
        if not idx:
            return None
        axis = depth % self.dims
        idx.sort(key=lambda i: self.items[i, axis])
        mid = len(idx) // 2
        node = _KDNode(idx[mid], axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def search(self, target, k: int) -> Tuple[List[int], List[float]]:
        """k nearest indices + euclidean distances, ascending. TIE-STABLE
        like VPTree.search: equal distances resolve to the lower index
        (the heap orders lexicographically on (d, i), and the far-side
        bound is INCLUSIVE so an equal-distance lower-index point across
        the splitting plane is still reached) — exactly the first k of
        ``sorted((d_i, i))``, deterministic on duplicate-heavy inputs."""
        if k < 1:
            raise ValueError(f"k must be >= 1; got {k}")
        target = np.asarray(target, np.float64)
        heap: List[Tuple[float, int]] = []  # (-d, -i): heap[0] = worst kept

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.items[node.index] - target))
            if len(heap) < k:
                heapq.heappush(heap, (-d, -node.index))
            elif (d, node.index) < (-heap[0][0], -heap[0][1]):
                heapq.heapreplace(heap, (-d, -node.index))
            diff = target[node.axis] - self.items[node.index, node.axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) <= -heap[0][0]:
                visit(far)

        visit(self._root)
        pairs = sorted((-nd, -ni) for nd, ni in heap)
        return [i for _, i in pairs], [d for d, _ in pairs]

    def nn(self, target) -> Tuple[int, float]:
        idx, dist = self.search(target, 1)
        return idx[0], dist[0]
