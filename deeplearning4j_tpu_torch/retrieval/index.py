"""Device vector indexes: batched top-k over a resident corpus (counterpart
of ``deeplearning4j_tpu/retrieval/index.py``).

The whole corpus lives in device memory and one dispatch answers a whole
query batch,

    d²(q, V) = |q|² − 2·q·Vᵀ + |V|²
    top-k     = the k smallest d², ties lower index first

- :class:`BruteForceIndex` — exact, the recall oracle; ``int8=True`` keeps
  the table on quant/'s symmetric int8 grid with per-vector scales,
  ``int4=True`` packs two codes per byte and scores through the
  ``int4_dot`` kernel (``perf/kernels/int4_dot.py``), the counterpart of
  the JAX package's ``score_brute_int4``.
- Product quantization (``retrieval/pq.py``): :class:`PQIndex`,
  :class:`IVFPQIndex`.

Arrays, layouts and the ``.npz`` written by ``save()`` are the JAX
package's, so an index crosses between the packages as a file. The JAX
``IVFIndex`` (dense and CSR cells) runs no TPU kernel and is not ported
yet: ``load_index`` of kind ``"ivf"`` raises.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (``device.resolve_device``). Host code pads each query
batch to the ``BucketPolicy`` ladder and ``k`` to a pow2 rung, as the JAX
package does; a dispatch reads its answer back to the host once.

Top-k order is the JAX package's ``lax.top_k(-d2, k)`` order exactly:
ascending in float32's total order (-0.0 before +0.0, inf last), ties
lower index first (:func:`_topk_smallest`). ``torch.topk`` alone promises
no tie order.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.perf.bucketing import BucketPolicy, pad_to_bucket
from deeplearning4j_tpu_torch.perf.kernels import int4_dot
from deeplearning4j_tpu_torch.quant.observers import QMAX, observe_stream
from deeplearning4j_tpu_torch.quant.pack import (QMAX4, quantize_int4,
                                                 unpack_nibbles_host)

__all__ = ["BruteForceIndex", "load_index"]

_METRICS = ("euclidean", "cosine")

# assignment chunk for IVF builds: bounds the (chunk, n_cells) distance
# matrix so a million-vector build never materializes n×C at once
_ASSIGN_CHUNK = 16384


def _pow2ceil(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def _as_tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else int(t.numel() * t.element_size())


# ---------------------------------------------------------------- scoring
def _topk_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of float32 ``d2``, ascending,
    ties lower index first: ``lax.top_k(-d2, k)``'s order exactly (the JAX
    package's total order on float32, so -0.0 comes before +0.0 and inf
    after every finite value). Returns ``(values, int64 indices)``.

    Each float maps to its order-preserving int32 (flip the magnitude bits
    of negatives), and ``ordered * 2**32 + index`` is an int64 key that no
    two entries share; ``torch.topk`` on it is exact and sorted."""
    n = d2.shape[1]
    bits = d2.contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = ordered.to(torch.int64)
    key.mul_(1 << 32).add_(torch.arange(n, dtype=torch.int64, device=d2.device))
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    idx = top & 0xFFFFFFFF
    return d2.gather(1, idx), idx


def _centroid_d2(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(b, C) squared query→centroid distances, the probe scorer."""
    return ((centroids * centroids).sum(1)[None, :]
            - 2.0 * (q @ centroids.T)
            + (q * q).sum(1, keepdim=True))


def _metric_tail(q, dots, vnorm2, k: int, metric: str):
    if metric == "cosine":
        # vecs/q are unit vectors; angular distance = arccos(cos)
        cos = torch.clamp(dots, -1.0, 1.0)
        neg, idx = _topk_smallest(-cos, k)
        return torch.arccos(-neg), idx
    d2 = vnorm2[None, :] - 2.0 * dots + (q * q).sum(1, keepdim=True)
    vals, idx = _topk_smallest(d2, k)
    return torch.sqrt(torch.clamp_min(vals, 0.0)), idx


def _score_brute(q, vecs, vnorm2, k: int, metric: str):
    return _metric_tail(q, q @ vecs.T, vnorm2, k, metric)


def _score_quantize_rows(q: torch.Tensor):
    """Quantize each query ROW onto its own symmetric int8 grid. Per-row
    (not per-batch) so a request's answer never depends on which other
    requests it was coalesced with."""
    amax = torch.clamp_min(q.abs().amax(dim=1, keepdim=True), 1e-12)
    scale = amax / QMAX
    qq = torch.clamp(torch.round(q / scale), -QMAX, QMAX).to(torch.int8)
    return qq, scale


def _brute_i8_topk(q, doti, vnorm2, scale_v, scale_q, k: int, metric: str):
    """Shared tail of the quantized brute scorers: ``doti`` is the exact
    int32 (b, n) product of the int8 queries and the table's codes."""
    dots = doti.to(torch.float32) * scale_q * scale_v[None, :]
    return _metric_tail(q, dots, vnorm2, k, metric)


def _score_brute_int8(q, vecs_q, vnorm2, scale_v, k: int, metric: str):
    qq, scale_q = _score_quantize_rows(q)
    # the exact integer product: float64 holds every partial sum of int8
    # products exactly (torch.matmul has no int32 kernel on CUDA)
    doti = (qq.to(torch.float64) @ vecs_q.to(torch.float64).T).to(torch.int32)
    return _brute_i8_topk(q, doti, vnorm2, scale_v, scale_q, k, metric)


def _score_brute_int4(q, packed, vnorm2, scale_v, k: int, metric: str):
    qq, scale_q = _score_quantize_rows(q)
    doti = int4_dot.int4_matmul(qq, packed, q.shape[1])
    return _brute_i8_topk(q, doti, vnorm2, scale_v, scale_q, k, metric)


def _csr_slots(offsets: torch.Tensor, probe: torch.Tensor, cand_pad: int):
    """Segment arithmetic for the CSR layout: map each of ``cand_pad``
    candidate slots to (probe segment, flat row). The probed ranges
    concatenate in probe-major / within-cell order. Returns ``(seg, pos,
    valid)``, each (b, cand_pad); ``seg`` and ``pos`` are int32, as in the
    JAX package (torch's cumsum and searchsorted would give int64)."""
    p = probe.shape[1]
    starts = offsets[probe]                                # (b, p) int32
    counts = offsets[probe + 1] - starts
    ends = torch.cumsum(counts, dim=1, dtype=torch.int32)  # inclusive
    begins = ends - counts
    slot = torch.arange(cand_pad, dtype=torch.int32, device=offsets.device)
    slot = slot[None, :].expand(probe.shape[0], cand_pad).contiguous()
    # segment of a slot = number of segment ends <= slot
    seg = torch.searchsorted(ends, slot, right=True, out_int32=True)
    seg = torch.clamp_max(seg, p - 1)
    seg64 = seg.long()
    within = slot - torch.gather(begins, 1, seg64)
    pos = torch.gather(starts, 1, seg64) + within
    valid = slot < ends[:, -1:]
    pos = torch.where(valid, pos, torch.zeros((), dtype=pos.dtype, device=pos.device))
    return seg, pos.to(torch.int32), valid


# ----------------------------------------------------------- quantization
def _quantize_table(vecs: np.ndarray, observer: str, chunk: int = 65536
                    ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Symmetric int8 table quantization with PER-VECTOR scales (``s_i =
    amax_i / 127``) under the observer's table-level clipping ceiling.
    Returns ``(int8 table, per-row scales, table-level wire scale)``."""
    obs = observe_stream(vecs, observer, chunk)
    ceiling = max(float(obs.amax()), 1e-12)
    row_amax = np.abs(vecs).max(axis=1) if len(vecs) else np.zeros(0)
    amax = np.clip(row_amax, 1e-12, ceiling)
    scales = (amax / QMAX).astype(np.float32)
    q = np.clip(np.rint(vecs / scales[:, None]), -QMAX, QMAX
                ).astype(np.int8)
    return q, scales, float(obs.scale())


def _train_cells(v: np.ndarray, n_cells: int, train_size: int,
                 max_iterations: int, seed: int, device
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """KMeans cells on a seeded subsample + full-corpus assignment — the
    coarse-quantizer recipe of the IVF family. Returns ``(centroids (C, d),
    assign (n,))``."""
    rng = np.random.default_rng(seed)
    if len(v) > train_size:
        sample = v[rng.choice(len(v), train_size, replace=False)]
    else:
        sample = v
    km = KMeansClustering(n_cells, max_iterations=max_iterations,
                          seed=seed, device=device)
    km.apply_to(sample)
    centroids = km.centroids.astype(np.float32)
    return centroids, _assign_all(v, centroids, device)


def _assign_all(v: np.ndarray, centroids: np.ndarray, device) -> np.ndarray:
    """Nearest-centroid assignment for a whole corpus, chunked so the
    (chunk, n_cells) distance matrix stays bounded."""
    dev = resolve_device(device)
    c = _as_tensor(centroids, dev)
    out = np.empty(len(v), np.int64)
    for lo in range(0, len(v), _ASSIGN_CHUNK):
        chunk = _as_tensor(v[lo:lo + _ASSIGN_CHUNK], dev)
        out[lo:lo + len(chunk)] = torch.argmin(
            _centroid_d2(chunk, c), dim=1).cpu().numpy()
    return out


def _rerank_exact(table: np.ndarray, q: np.ndarray, ids: np.ndarray,
                  k: int):
    """Host-side exact re-rank of compressed-index candidates against
    the fp32 table: tie-stable ((d², id) lexicographic), pads (id −1) keep
    answering inf. Runs after the device dispatch returned."""
    safe = np.maximum(ids, 0)
    cand = table[safe]                                    # (b, rk, d)
    diff = cand - q[:, None, :]
    d2 = np.einsum("brd,brd->br", diff, diff)
    d2 = np.where(ids < 0, np.inf, d2)
    order = np.lexsort((ids, d2), axis=-1)[:, :k]
    top = np.take_along_axis(ids, order, axis=1).astype(np.int32)
    dd = np.sqrt(np.maximum(
        np.take_along_axis(d2, order, axis=1), 0.0)).astype(np.float32)
    dd[top < 0] = np.inf
    return top, dd


# ------------------------------------------------------------------ base
class _DeviceIndex:
    """Shared host-side surface: query-batch bucketing, the pow2 k ladder,
    warmup, npz persistence and the opt-in exact re-rank.

    ``rerank=r`` (any compressed index, euclidean only): the device
    answers the top ``r·k`` approximate candidates and a host pass
    re-scores them exactly against the original fp32 vectors, kept on the
    HOST, so ``memory_bytes()`` stays the compressed device footprint."""

    kind = "base"

    def __init__(self, vectors, *, metric: str = "euclidean",
                 int8: bool = False, int4: bool = False,
                 rerank: int = 0, observer: str = "minmax",
                 labels: Optional[Sequence[str]] = None,
                 query_policy: Optional[BucketPolicy] = None,
                 device=None):
        self.device = resolve_device(device)
        v = np.asarray(vectors, np.float32)
        if v.ndim != 2 or v.shape[0] < 1:
            raise ValueError(
                f"index needs a (n, d) vector matrix; got shape {v.shape}")
        if not np.isfinite(v).all():
            raise ValueError("index vectors contain non-finite values")
        if metric not in _METRICS:
            raise ValueError(f"unsupported metric {metric!r} "
                             f"(supported: {list(_METRICS)})")
        if int8 and int4:
            raise ValueError("int8 and int4 are one codec knob — pick one")
        if rerank < 0:
            raise ValueError(f"rerank must be >= 0; got {rerank}")
        if rerank and metric != "euclidean":
            raise ValueError("rerank re-scores euclidean d² on the host "
                             "— cosine tables don't compose with it")
        if labels is not None and len(labels) != len(v):
            raise ValueError(
                f"labels length {len(labels)} != num vectors {len(v)}")
        if metric == "cosine":
            norms = np.linalg.norm(v, axis=1, keepdims=True)
            v = v / np.maximum(norms, 1e-12)
        self.metric = metric
        self.size = int(v.shape[0])
        self.dim = int(v.shape[1])
        self.int8 = bool(int8)
        self.int4 = bool(int4)
        self.rerank = int(rerank)
        self.observer = observer
        self.scale: Optional[float] = None
        self.labels = list(labels) if labels is not None else None
        self.query_policy = (query_policy if query_policy is not None
                             else BucketPolicy(floor=8, cap=4096))
        self._rerank_vecs = v if self.rerank else None
        self._build(v)

    # ------------------------------------------------------------ plumbing
    def _build(self, v: np.ndarray):
        raise NotImplementedError

    def _candidates(self) -> int:
        """Vectors scored per query (the ceiling for k)."""
        raise NotImplementedError

    def _search_device(self, q: torch.Tensor, k: int):
        """Score an already-padded device batch; returns device
        ``(distances, indices)`` without waiting for them."""
        raise NotImplementedError

    @property
    def codec(self) -> str:
        """Compression rung of the stored table: fp32 / int8 / int4 (the
        PQ classes answer "pq")."""
        return "int8" if self.int8 else ("int4" if self.int4 else "fp32")

    @property
    def max_k(self) -> int:
        """Largest k a query may ask for (the per-query candidate count)."""
        return self._candidates()

    def _k_pad(self, k: int) -> int:
        if k < 1:
            raise ValueError(f"k must be >= 1; got {k}")
        cand = self._candidates()
        if k > cand:
            raise ValueError(
                f"k={k} exceeds the {cand} candidates this index scores "
                "per query" + (" (raise nprobe or rebuild with more "
                               "cells)" if self.kind.startswith("ivf")
                               else ""))
        return min(1 << (int(k) - 1).bit_length(), cand)

    def _rerank_k(self, k: int) -> int:
        """Candidate count the device answers when re-ranking."""
        return max(int(k), min(self.rerank * int(k), self._candidates()))

    # -------------------------------------------------------------- search
    def search(self, queries, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: ``queries`` is (b, d) (a single (d,) vector is
        auto-promoted); returns ``(indices, distances)`` as (b, k) host
        arrays, each row ascending by distance."""
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be (b, {self.dim}); got shape {q.shape}")
        idx, dist = self._search_batch(q, int(k))
        if single:
            return idx[0], dist[0]
        return idx, dist

    def _search_batch(self, q: np.ndarray, k: int):
        k_dev = self._rerank_k(k) if self.rerank else k
        kp = self._k_pad(k_dev)
        target = self.query_policy.bucket(q.shape[0])
        qp = pad_to_bucket(q, target)
        if self.metric == "cosine":
            qp = qp / np.maximum(np.linalg.norm(qp, axis=1, keepdims=True),
                                 1e-12)
        dist, idx = self._search_device(_as_tensor(qp, self.device), kp)
        # the one host read of the dispatch
        dist = dist[:q.shape[0], :k_dev].cpu().numpy()
        idx = idx[:q.shape[0], :k_dev].to(torch.int32).cpu().numpy()
        if self.rerank:
            return _rerank_exact(self._rerank_vecs, q, idx, k)
        return idx, dist

    def warmup(self, max_queries: int = 64,
               ks: Sequence[int] = (10,)) -> List[Tuple[int, int]]:
        """Dispatch every (query-bucket × k-rung) pair once — on the card
        that builds and loads the kernels and sizes PyTorch's allocator
        before live traffic. Returns the warmed (batch, k) pairs. With
        ``rerank`` on, each requested k warms its ``rerank·k`` rung."""
        warmed = []
        if self.rerank:
            ks = tuple(self._rerank_k(int(k)) for k in ks)
        kpads = sorted({self._k_pad(int(k)) for k in ks})
        zeros = np.zeros((1, self.dim), np.float32)
        for b in self.query_policy.buckets_up_to(max(1, int(max_queries))):
            qp = _as_tensor(pad_to_bucket(zeros, b), self.device)
            for kp in kpads:
                d, i = self._search_device(qp, kp)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                warmed.append((b, kp))
        return warmed

    # -------------------------------------------------------------- stats
    def memory_bytes(self) -> int:
        """DEVICE-resident index bytes (a re-rank index's host-side fp32
        table is NOT in here; see ``stats()['rerank_bytes_host']``)."""
        raise NotImplementedError

    def nbytes(self) -> int:
        """Back-compat alias of :meth:`memory_bytes`."""
        return self.memory_bytes()

    def code_bytes(self) -> int:
        """Bytes of the stored table/codes arrays alone."""
        raise NotImplementedError

    def stats(self) -> dict:
        mb = self.memory_bytes()
        return {"kind": self.kind, "metric": self.metric,
                "size": self.size, "dim": self.dim, "int8": self.int8,
                "int4": self.int4, "codec": self.codec,
                "rerank": self.rerank,
                "rerank_bytes_host": (int(self._rerank_vecs.nbytes)
                                      if self._rerank_vecs is not None
                                      else 0),
                "scale": self.scale, "nbytes": mb, "memory_bytes": mb,
                "code_bytes": self.code_bytes(),
                "bytes_per_vector": round(mb / max(1, self.size), 2),
                "device": str(self.device)}

    # --------------------------------------------------------- persistence
    def _meta(self) -> dict:
        qp = self.query_policy
        return {"kind": self.kind, "metric": self.metric,
                "int8": self.int8, "int4": self.int4,
                "rerank": self.rerank,
                "observer": self.observer,
                "scale": self.scale, "size": self.size, "dim": self.dim,
                "labels": self.labels,
                "query_policy": {"floor": qp.floor, "cap": qp.cap,
                                 "buckets": qp._explicit}}

    def _arrays(self) -> dict:
        raise NotImplementedError

    def save(self, path: str) -> str:
        """One ``.npz``: arrays + a JSON meta entry, the JAX package's
        format (its ``load_index`` reads it back, and this package's reads
        the JAX package's). A re-rank index's fp32 table rides along."""
        arrays = {k: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
                  for k, a in self._arrays().items()}
        if self._rerank_vecs is not None:
            arrays["rerank_vecs"] = self._rerank_vecs
        arrays["meta_json"] = np.frombuffer(
            json.dumps(self._meta()).encode(), dtype=np.uint8)
        np.savez(path, **arrays)
        return path

    def _restore_common(self, meta: dict, arrays: Optional[dict] = None,
                        device=None):
        """Rehydrate the base fields ``load_index`` hands every kind."""
        self.device = resolve_device(device)
        self.metric = meta["metric"]
        self.size = int(meta["size"])
        self.dim = int(meta["dim"])
        self.int8 = bool(meta["int8"])
        self.int4 = bool(meta.get("int4", False))
        self.rerank = int(meta.get("rerank", 0) or 0)
        self._rerank_vecs = (np.asarray((arrays or {}).get("rerank_vecs"),
                                        np.float32)
                             if self.rerank and arrays
                             and "rerank_vecs" in arrays else None)
        if self.rerank and self._rerank_vecs is None:
            raise ValueError("index metadata says rerank but the npz "
                             "carries no rerank_vecs table")
        self.observer = meta.get("observer", "minmax")
        self.scale = meta.get("scale")
        self.labels = meta.get("labels")
        qp = meta.get("query_policy") or {}
        self.query_policy = BucketPolicy(floor=qp.get("floor", 8),
                                         cap=qp.get("cap", 4096),
                                         buckets=qp.get("buckets"))


# ----------------------------------------------------------- brute force
class BruteForceIndex(_DeviceIndex):
    """Exact top-k: every query scores the whole device-resident corpus
    in one matrix product + top-k. The recall oracle for int8/int4/PQ.
    ``int8=True`` quantizes the table ×4; ``int4=True`` packs two codes
    per byte for ×8 over float32 and scores through ``int4_dot``."""

    kind = "brute"

    def _build(self, v: np.ndarray):
        if self.int8:
            q, scales, self.scale = _quantize_table(v, self.observer)
            deq = q.astype(np.float32) * scales[:, None]
            self._set_tables(q, np.sum(deq ** 2, axis=1), scales)
        elif self.int4:
            packed, scales, wire4 = quantize_int4(v, observer=self.observer)
            # wire scale stays the int8 whole-vector grid: clients keep
            # quantizing queries to int8 regardless of the table codec
            self.scale = float(wire4 * QMAX4 / QMAX)
            deq = (unpack_nibbles_host(packed, self.dim).astype(np.float32)
                   * scales[:, None])
            self._set_tables(packed, np.sum(deq ** 2, axis=1), scales)
        else:
            self._set_tables(v, np.sum(v.astype(np.float64) ** 2,
                                       axis=1).astype(np.float32), None)

    def _set_tables(self, vecs, vnorm2, scales):
        self._vecs = _as_tensor(vecs, self.device)
        self._vnorm2 = _as_tensor(np.asarray(vnorm2, np.float32), self.device)
        self._scales = (None if scales is None
                        else _as_tensor(np.asarray(scales, np.float32), self.device))

    def _candidates(self) -> int:
        return self.size

    def _search_device(self, q, k: int):
        if self.int4:
            return _score_brute_int4(q, self._vecs, self._vnorm2,
                                     self._scales, k, self.metric)
        if self.int8:
            return _score_brute_int8(q, self._vecs, self._vnorm2,
                                     self._scales, k, self.metric)
        return _score_brute(q, self._vecs, self._vnorm2, k, self.metric)

    def memory_bytes(self) -> int:
        return _nbytes(self._vecs) + _nbytes(self._vnorm2) + _nbytes(self._scales)

    def code_bytes(self) -> int:
        return _nbytes(self._vecs)

    def _arrays(self) -> dict:
        out = {"vecs": self._vecs, "vnorm2": self._vnorm2}
        if self._scales is not None:
            out["scales"] = self._scales
        return out

    @classmethod
    def load(cls, path: str, device=None) -> "BruteForceIndex":
        return _load_as(cls, path, device)


# ----------------------------------------------------------- persistence
def _load_as(cls, path: str, device=None) -> "_DeviceIndex":
    idx = load_index(path, device)
    if not isinstance(idx, cls):
        raise ValueError(f"{path} holds a {type(idx).__name__}, "
                         f"not a {cls.__name__}")
    return idx


def load_index(path: str, device=None) -> "_DeviceIndex":
    """Rebuild a saved index (``save()``'s npz, from either package)
    without re-clustering or re-quantizing, on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "meta_json"}
    kind = meta.get("kind")
    if kind in ("pq", "ivf_pq"):
        from deeplearning4j_tpu_torch.retrieval import pq
        return pq._load_pq(kind, meta, arrays, device)
    if kind == "brute":
        idx = BruteForceIndex.__new__(BruteForceIndex)
        idx._restore_common(meta, arrays, device)
        idx._set_tables(arrays["vecs"], arrays["vnorm2"], arrays.get("scales"))
        return idx
    if kind == "ivf":
        raise NotImplementedError(
            f"{path} holds an IVFIndex (dense/CSR cells): the port serves "
            "brute-force, PQ and IVF-PQ indexes so far; IVFIndex comes in a "
            "later slice of the port (ROADMAP.md, section A)")
    raise ValueError(f"unknown index kind {kind!r} in {path}")
