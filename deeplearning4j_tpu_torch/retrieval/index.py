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
- :class:`IVFIndex` — inverted-file coarse index: K-Means cells, the
  ``nprobe`` nearest probed per query. ``layout="dense"`` keeps one padded
  ``(n_cells, cap, d)`` block (every cell padded to the largest);
  ``layout="csr"`` keeps the corpus flat in cell-major order plus a
  ``(n_cells+1,)`` offsets array and gathers each query's probed ranges
  into a candidate axis padded to one pow2 rung, with identical results.
  ``int8=True`` / ``int4=True`` store RESIDUAL codes (``v − centroid``)
  with per-vector scales and score a per-cell recentred int8 query against
  them with exact integer dot products. Scoring is plain torch (gathers,
  batched products, the tie-ordered top-k): the JAX package's IVF scorers
  are XLA programs, not kernels.
- Product quantization (``retrieval/pq.py``): :class:`PQIndex`,
  :class:`IVFPQIndex`.

Arrays, layouts and the ``.npz`` written by ``save()`` are the JAX
package's, so an index crosses between the packages as a file.

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
from deeplearning4j_tpu_torch.perf.compile_watch import CompileWatch
from deeplearning4j_tpu_torch.perf.kernels import int4_dot
from deeplearning4j_tpu_torch.quant.observers import QMAX, observe_stream
from deeplearning4j_tpu_torch.quant.pack import (QMAX4, quantize_int4, unpack_nibbles,
                                                 unpack_nibbles_host)

__all__ = ["BruteForceIndex", "IVFIndex", "load_index"]

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


def _int_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 result of an einsum of int8 operands (integer
    matrix products have no CUDA kernel in torch): in float32 while every
    partial sum stays below 2**24, which holds for d * 127**2 < 2**24, else
    in float64."""
    d = a.shape[-1]
    dt = torch.float32 if d * 127 * 127 < (1 << 24) else torch.float64
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(torch.int32)


def _probe(q, centroids, nprobe: int):
    """(cd2 (b, C), probe (b, nprobe)): the probed cells, nearest first,
    ties lower cell first (``lax.top_k(-cd2, nprobe)``'s order)."""
    cd2 = _centroid_d2(q, centroids)
    return cd2, _topk_smallest(cd2, nprobe)[1]


def _dist_topk(d2, cand_ids, k: int):
    vals, pos = _topk_smallest(d2, k)
    return torch.sqrt(torch.clamp_min(vals, 0.0)), cand_ids.gather(1, pos)


def _score_ivf(q, centroids, cells, ids, vnorm2, k: int, nprobe: int):
    b = q.shape[0]
    qn2 = (q * q).sum(1, keepdim=True)
    _, probe = _probe(q, centroids, nprobe)
    cand = cells[probe]                                   # (b, p, cap, d)
    cand_ids = ids[probe].reshape(b, -1)                  # (b, p·cap)
    cand_n2 = vnorm2[probe].reshape(b, -1)                # +inf on pads
    dots = torch.einsum("bd,bpcd->bpc", q, cand).reshape(b, -1)
    return _dist_topk(cand_n2 - 2.0 * dots + qn2, cand_ids, k)


def _recenter_queries(q, centroids, probe):
    """RESIDUAL recentring (the FAISS IVF encoding): per probed cell,
    quantize ``q − c`` onto its own int8 grid. Returns (codes (b, p, d)
    int8, scales (b, p, 1))."""
    qc = q[:, None, :] - centroids[probe]                 # (b, p, d)
    amax = torch.clamp_min(qc.abs().amax(dim=2, keepdim=True), 1e-12)
    s_qc = amax / QMAX
    qcq = torch.clamp(torch.round(qc / s_qc), -QMAX, QMAX).to(torch.int8)
    return qcq, s_qc


def _ivf_residual_topk(q, cd2, probe, cand, cand_ids, cand_n2, cand_s,
                       centroids, k: int):
    """Shared tail of the dense residual-quantized scorers: ``cand`` is
    int8 residual codes (b, p, cap, d). |q−v|² = |q−c|² − 2·(q−c)·r + |r|²,
    with |q−c|² the probe distance already computed."""
    b = q.shape[0]
    qcq, s_qc = _recenter_queries(q, centroids, probe)
    doti = _int_dot("bpd,bpcd->bpc", qcq, cand)
    dots = (doti.to(torch.float32) * s_qc * cand_s).reshape(b, -1)
    cqd2 = cd2.gather(1, probe)                           # |q−c|² (b, p)
    d2 = (torch.repeat_interleave(cqd2, cand.shape[2], dim=1)
          - 2.0 * dots + cand_n2)
    return _dist_topk(d2, cand_ids, k)


def _score_ivf_int8(q, centroids, cells_q, ids, rnorm2, scales, k: int, nprobe: int,
                    int4: bool = False):
    b = q.shape[0]
    cd2, probe = _probe(q, centroids, nprobe)
    cand = cells_q[probe]                                 # (b, p, cap, d|d/2)
    if int4:
        # gather first, then unpack only the probed cells
        cand = unpack_nibbles(cand, q.shape[1])
    return _ivf_residual_topk(q, cd2, probe, cand, ids[probe].reshape(b, -1),
                              rnorm2[probe].reshape(b, -1), scales[probe],
                              centroids, k)


def _score_ivf_csr(q, centroids, flat, flat_ids, flat_n2, offsets,
                   k: int, nprobe: int, cand_pad: int):
    _, probe = _probe(q, centroids, nprobe)
    seg, pos, valid = _csr_slots(offsets, probe, cand_pad)
    pos = pos.long()
    cand = flat[pos]                                      # (b, C, d)
    cand_ids = torch.where(valid, flat_ids[pos], torch.full_like(flat_ids[pos], -1))
    cand_n2 = torch.where(valid, flat_n2[pos], torch.full_like(flat_n2[pos], float("inf")))
    dots = torch.einsum("bd,bcd->bc", q, cand)
    d2 = cand_n2 - 2.0 * dots + (q * q).sum(1, keepdim=True)
    return _dist_topk(d2, cand_ids, k)


def _score_ivf_csr_int8(q, centroids, flat_q, flat_ids, flat_n2, flat_s, offsets,
                        k: int, nprobe: int, cand_pad: int, int4: bool = False):
    """The CSR residual-quantized scorers: each slot's integer dot is read
    from the (b, p, C) products of every probed cell's recentred query
    with every candidate, at the slot's own cell ``seg``."""
    cd2, probe = _probe(q, centroids, nprobe)
    seg, pos, valid = _csr_slots(offsets, probe, cand_pad)
    pos, seg = pos.long(), seg.long()
    cand = flat_q[pos]                                    # (b, C, d|d/2)
    if int4:
        cand = unpack_nibbles(cand, q.shape[1])
    ids_at = flat_ids[pos]
    cand_ids = torch.where(valid, ids_at, torch.full_like(ids_at, -1))
    qcq, s_qc = _recenter_queries(q, centroids, probe)    # (b, p, d)
    doti = _int_dot("bpd,bcd->bpc", qcq, cand).gather(1, seg[:, None, :])[:, 0]
    sslot = s_qc[..., 0].gather(1, seg)                   # (b, C)
    dots = doti.to(torch.float32) * sslot * flat_s[pos]
    cslot = cd2.gather(1, probe).gather(1, seg)           # |q−c|² per slot
    d2 = torch.where(valid, cslot - 2.0 * dots + flat_n2[pos],
                     torch.full_like(dots, float("inf")))
    return _dist_topk(d2, cand_ids, k)


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
    def compile_watch(self) -> CompileWatch:
        """Dispatches of the scoring step and its first-seen (batch, k)
        shapes (``perf/compile_watch.py``), under the key ``search``."""
        cw = self.__dict__.get("_compile_watch")
        if cw is None:
            cw = self.__dict__["_compile_watch"] = CompileWatch(f"retrieval.{self.kind}")
        return cw

    def _search_watched(self, q: torch.Tensor, k: int):
        """:meth:`_search_device` through ``compile_watch``."""
        w = self.__dict__.get("_search_watch")
        if w is None:
            w = self.__dict__["_search_watch"] = self.compile_watch.wrap(
                self._search_device, "search")
        return w(q, k)

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
        dist, idx = self._search_watched(_as_tensor(qp, self.device), kp)
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
                d, i = self._search_watched(qp, kp)
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
                "device": str(self.device),
                "compile_watch": self.compile_watch.as_dict()}

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


# ------------------------------------------------------------------- IVF
class IVFIndex(_DeviceIndex):
    """Inverted-file index: K-Means cells, ``nprobe`` probed per query —
    work scales with the probed candidates instead of ``n``. Cells are
    learned on a seeded subsample (``train_size``) and every vector is then
    assigned to its nearest final centroid in chunks (``_train_cells``).

    ``layout="dense"`` keeps padded ``(n_cells, cap, d)`` blocks (cap = the
    LARGEST cell); ``layout="csr"`` keeps the corpus flat in cell-major
    order + a ``(n_cells+1,)`` offsets array and pads only the per-query
    gathered candidate axis to one pow2 rung (``cand_pad``), so resident
    memory is exactly ``n`` rows, at identical query results."""

    kind = "ivf"

    def __init__(self, vectors, *, n_cells: Optional[int] = None,
                 nprobe: int = 8, train_size: int = 100_000,
                 max_iterations: int = 25, seed: int = 123,
                 layout: str = "dense", **kwargs):
        if kwargs.get("metric", "euclidean") != "euclidean":
            raise ValueError("IVFIndex supports euclidean only (KMeans "
                             "cells are euclidean centroids)")
        if layout not in ("dense", "csr"):
            raise ValueError(f"unknown cell layout {layout!r} "
                             "(known: 'dense', 'csr')")
        n = int(np.asarray(vectors).shape[0])
        self.n_cells = (max(1, int(round(n ** 0.5))) if n_cells is None
                        else int(n_cells))
        if self.n_cells > n:
            raise ValueError(f"n_cells={self.n_cells} exceeds corpus size {n}")
        self.nprobe = min(int(nprobe), self.n_cells)
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1; got {nprobe}")
        self.train_size = int(train_size)
        self.max_iterations = int(max_iterations)
        self.seed = int(seed)
        self.layout = layout
        super().__init__(vectors, **kwargs)

    def _build(self, v: np.ndarray):
        centroids, assign = _train_cells(v, self.n_cells, self.train_size,
                                         self.max_iterations, self.seed, self.device)
        counts = np.bincount(assign, minlength=self.n_cells)
        self.cell_counts = counts
        self.cap = max(1, int(counts.max()))
        self._centroids = _as_tensor(centroids, self.device)
        order = np.argsort(assign, kind="stable")
        if self.int8 or self.int4:
            # RESIDUAL encoding: quantize v − centroid[cell], whose amax is
            # the cell radius; the published WIRE scale stays in the
            # query's (whole-vector) space
            res = v - centroids[assign]
            if self.int4:
                codes, scales, _ = quantize_int4(res, observer=self.observer)
                deq = (unpack_nibbles_host(codes, self.dim).astype(np.float32)
                       * scales[:, None])
            else:
                codes, scales, _ = _quantize_table(res, self.observer)
                deq = codes.astype(np.float32) * scales[:, None]
            self.scale = float(observe_stream(v, self.observer).scale())
            norm2 = np.sum(deq ** 2, axis=1).astype(np.float32)  # |r̂|²
            table = codes
        else:
            scales = None
            norm2 = np.sum(v.astype(np.float64) ** 2, axis=1).astype(np.float32)
            table = v
        if self.layout == "csr":
            self._build_csr(table, scales, norm2, order, counts)
        else:
            self._build_dense(table, scales, norm2, order, counts)

    def _build_dense(self, table, scales, norm2, order, counts):
        width = table.shape[1]  # the packed width for int4, d otherwise
        cells = np.zeros((self.n_cells, self.cap, width), table.dtype)
        ids = np.full((self.n_cells, self.cap), -1, np.int32)
        vnorm2 = np.full((self.n_cells, self.cap), np.inf, np.float32)
        ofs = 0
        for c in range(self.n_cells):
            m = int(counts[c])
            rows = order[ofs:ofs + m]
            ofs += m
            cells[c, :m] = table[rows]
            ids[c, :m] = rows
            vnorm2[c, :m] = norm2[rows]
        cscales = None
        if scales is not None:
            cscales = np.ones((self.n_cells, self.cap), np.float32)
            cscales[ids >= 0] = scales[ids[ids >= 0]]
        self._set_dense(cells, ids, vnorm2, cscales)
        self.cand_pad = None

    def _build_csr(self, table, scales, norm2, order, counts):
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        self._set_csr(table[order], order.astype(np.int32), norm2[order], offsets,
                      None if scales is None else scales[order])
        # the per-query gathered candidate axis: the pow2 rung covering the
        # nprobe FULLEST cells
        worst = int(np.sort(counts)[-self.nprobe:].sum())
        self.cand_pad = _pow2ceil(max(1, worst))

    def _set_dense(self, cells, ids, vnorm2, scales):
        dev = self.device
        self._cells = _as_tensor(cells, dev)
        self._ids = _as_tensor(np.asarray(ids, np.int32), dev).long()
        self._vnorm2 = _as_tensor(np.asarray(vnorm2, np.float32), dev)
        self._scales = (None if scales is None
                        else _as_tensor(np.asarray(scales, np.float32), dev))
        self._flat = self._flat_ids = self._offsets = self._flat_scales = None

    def _set_csr(self, flat, flat_ids, vnorm2, offsets, flat_scales):
        dev = self.device
        self._flat = _as_tensor(flat, dev)
        self._flat_ids = _as_tensor(np.asarray(flat_ids, np.int32), dev).long()
        self._vnorm2 = _as_tensor(np.asarray(vnorm2, np.float32), dev)
        self._offsets = _as_tensor(np.asarray(offsets, np.int32), dev)
        self._flat_scales = (None if flat_scales is None
                             else _as_tensor(np.asarray(flat_scales, np.float32), dev))
        self._cells = self._ids = self._scales = None

    def _candidates(self) -> int:
        if self.layout == "csr":
            return min(self.size, self.cand_pad)
        return min(self.size, self.nprobe * self.cap)

    def _search_device(self, q, k: int):
        quant = self.int8 or self.int4
        if self.layout == "csr":
            if quant:
                return _score_ivf_csr_int8(q, self._centroids, self._flat, self._flat_ids,
                                           self._vnorm2, self._flat_scales, self._offsets,
                                           k, self.nprobe, self.cand_pad, int4=self.int4)
            return _score_ivf_csr(q, self._centroids, self._flat, self._flat_ids,
                                  self._vnorm2, self._offsets, k, self.nprobe,
                                  self.cand_pad)
        if quant:
            return _score_ivf_int8(q, self._centroids, self._cells, self._ids,
                                   self._vnorm2, self._scales, k, self.nprobe,
                                   int4=self.int4)
        return _score_ivf(q, self._centroids, self._cells, self._ids, self._vnorm2,
                          k, self.nprobe)

    def memory_bytes(self) -> int:
        # ids count at the JAX package's int32 width (held as int64 here
        # for indexing)
        n = _nbytes(self._vnorm2) + _nbytes(self._centroids)
        if self.layout == "csr":
            n += (_nbytes(self._flat) + 4 * self._flat_ids.numel()
                  + _nbytes(self._offsets) + _nbytes(self._flat_scales))
        else:
            n += _nbytes(self._cells) + 4 * self._ids.numel() + _nbytes(self._scales)
        return n

    def code_bytes(self) -> int:
        return _nbytes(self._flat if self.layout == "csr" else self._cells)

    def stats(self) -> dict:
        st = super().stats()
        st.update(n_cells=self.n_cells, nprobe=self.nprobe, cap=self.cap,
                  layout=self.layout,
                  empty_cells=int((self.cell_counts == 0).sum()))
        if self.layout == "csr":
            st["cand_pad"] = self.cand_pad
        return st

    def _meta(self) -> dict:
        m = super()._meta()
        m.update(n_cells=self.n_cells, nprobe=self.nprobe, cap=self.cap,
                 train_size=self.train_size, seed=self.seed,
                 max_iterations=self.max_iterations, layout=self.layout,
                 cand_pad=self.cand_pad)
        return m

    def _arrays(self) -> dict:
        out = {"centroids": self._centroids, "vnorm2": self._vnorm2,
               "cell_counts": self.cell_counts}
        if self.layout == "csr":
            out.update(flat=self._flat, flat_ids=self._flat_ids.to(torch.int32),
                       offsets=self._offsets)
            if self._flat_scales is not None:
                out["flat_scales"] = self._flat_scales
        else:
            out.update(cells=self._cells, ids=self._ids.to(torch.int32))
            if self._scales is not None:
                out["scales"] = self._scales
        return out

    @classmethod
    def load(cls, path: str, device=None) -> "IVFIndex":
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
    if kind != "ivf":
        raise ValueError(f"unknown index kind {kind!r} in {path}")
    idx = IVFIndex.__new__(IVFIndex)
    idx._restore_common(meta, arrays, device)
    idx.n_cells = int(meta["n_cells"])
    idx.nprobe = int(meta["nprobe"])
    idx.cap = int(meta["cap"])
    idx.train_size = int(meta.get("train_size", 100_000))
    idx.seed = int(meta.get("seed", 123))
    idx.max_iterations = int(meta.get("max_iterations", 25))
    idx.layout = meta.get("layout", "dense")
    idx.cand_pad = meta.get("cand_pad")
    idx.cell_counts = arrays["cell_counts"]
    idx._centroids = _as_tensor(np.asarray(arrays["centroids"], np.float32), idx.device)
    if idx.layout == "csr":
        idx._set_csr(arrays["flat"], arrays["flat_ids"], arrays["vnorm2"],
                     arrays["offsets"], arrays.get("flat_scales"))
    else:
        idx._set_dense(arrays["cells"], arrays["ids"], arrays["vnorm2"],
                       arrays.get("scales"))
    return idx
