"""Vantage-point tree for exact metric k-NN.

Parity surface: reference
``deeplearning4j-nearestneighbors-parent/nearestneighbor-core/src/main/java/
org/deeplearning4j/clustering/vptree/VPTree.java:48`` (build + search with
"euclidean" default distance, ``search(target, k, results, distances)``).

Host-side numpy: median-split construction, best-first pruning search.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "radius", "inside", "outside", "bucket")

    def __init__(self, index: int):
        self.index = index
        self.radius = 0.0
        self.inside: Optional["_Node"] = None
        self.outside: Optional["_Node"] = None
        self.bucket: Optional[List[int]] = None  # leaf: tied/duplicate points


class VPTree:
    """Exact k-NN under a metric (default euclidean; "cosine" supported via
    angular distance, which preserves the triangle inequality)."""

    def __init__(self, items: np.ndarray, distance: str = "euclidean",
                 seed: int = 123):
        self.items = np.asarray(items, np.float64)
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"Unsupported distance {distance!r}")
        self.distance = distance
        if distance == "cosine":
            norms = np.linalg.norm(self.items, axis=1, keepdims=True)
            self._unit = self.items / np.maximum(norms, 1e-12)
        rng = np.random.default_rng(seed)
        self._root = self._build(list(range(len(self.items))), rng)

    # ------------------------------------------------------------ distances
    def _dist_many(self, idx: List[int], point: np.ndarray) -> np.ndarray:
        if self.distance == "cosine":
            p = point / max(np.linalg.norm(point), 1e-12)
            cos = np.clip(self._unit[idx] @ p, -1.0, 1.0)
            return np.arccos(cos)  # angular distance: a true metric
        return np.linalg.norm(self.items[idx] - point, axis=1)

    # ---------------------------------------------------------------- build
    def _make_node(self, work: List[int], rng):
        """Pick a vantage point, median-split the rest. Returns
        (node, inside, outside) index lists (possibly empty)."""
        vp_pos = int(rng.integers(0, len(work)))
        work[0], work[vp_pos] = work[vp_pos], work[0]
        node = _Node(work[0])
        rest = work[1:]
        if not rest:
            return node, [], []
        d = self._dist_many(rest, self.items[node.index])
        node.radius = float(np.median(d))
        inside = [rest[i] for i in range(len(rest)) if d[i] < node.radius]
        outside = [rest[i] for i in range(len(rest)) if d[i] >= node.radius]
        if not inside:
            # radius == min distance (ties/duplicates at the median): bucket
            # ONLY the tied points; strictly-farther points keep splitting,
            # so search stays pruned even with many duplicates
            node.bucket = [rest[i] for i in range(len(rest))
                           if d[i] == node.radius]
            outside = [rest[i] for i in range(len(rest)) if d[i] > node.radius]
        return node, inside, outside

    def _build(self, idx: List[int], rng) -> Optional[_Node]:
        """Iterative construction (explicit work stack): never touches the
        Python recursion limit, even for duplicate-heavy inputs whose splits
        shed O(1) points per level."""
        if not idx:
            return None
        root, ins, outs = self._make_node(list(idx), rng)
        stack = [(ins, root, "inside"), (outs, root, "outside")]
        while stack:
            work, parent, side = stack.pop()
            if not work:
                continue
            node, ins, outs = self._make_node(work, rng)
            setattr(parent, side, node)
            stack.append((ins, node, "inside"))
            stack.append((outs, node, "outside"))
        return root

    # --------------------------------------------------------------- search
    def search(self, target, k: int) -> Tuple[List[int], List[float]]:
        """k nearest item indices + distances, ascending (reference
        VPTree.search). TIE-STABLE: equal distances resolve to the lower
        index — the result is exactly the first k of ``sorted((d_i, i))``,
        deterministic even on duplicate-heavy inputs, which is what lets
        this tree serve as the device indexes' recall oracle."""
        if k < 1:
            raise ValueError(f"k must be >= 1; got {k}")
        target = np.asarray(target, np.float64)
        # max-heap via negated (distance, index): heap[0] is the WORST
        # kept candidate under the lexicographic (d, i) order
        heap: List[Tuple[float, int]] = []
        tau = [np.inf]

        def offer(d: float, index: int):
            if len(heap) < k:
                heapq.heappush(heap, (-d, -index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif (d, index) < (-heap[0][0], -heap[0][1]):
                heapq.heapreplace(heap, (-d, -index))
                tau[0] = -heap[0][0]

        # iterative near-first traversal (far side pushed with its pruning
        # test deferred to pop time, when tau is tighter)
        stack: List[Tuple[Optional[_Node], Optional[float], Optional[float]]] = [
            (self._root, None, None)]
        while stack:
            node, parent_d, parent_radius = stack.pop()
            if node is None:
                continue
            if parent_d is not None:  # deferred far-side prune
                if not (parent_d - tau[0] <= parent_radius <= parent_d + tau[0]
                        or len(heap) < k):
                    continue
            d = float(self._dist_many([node.index], target)[0])
            offer(d, node.index)
            if node.bucket:
                # tied points sit exactly at node.radius from the vantage
                # point: the scan can be skipped unless the tau-ball overlaps
                # that shell
                if len(heap) < k or abs(d - node.radius) <= tau[0]:
                    for bd, bi in zip(self._dist_many(node.bucket, target),
                                      node.bucket):
                        offer(float(bd), bi)
            near, far = ((node.inside, node.outside) if d < node.radius
                         else (node.outside, node.inside))
            stack.append((far, d, node.radius))   # popped after near subtree
            stack.append((near, None, None))
        pairs = sorted((-nd, -ni) for nd, ni in heap)
        return [i for _, i in pairs], [d for d, _ in pairs]
