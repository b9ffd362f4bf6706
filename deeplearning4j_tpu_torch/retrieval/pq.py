"""Product quantization: 1-byte-per-subspace codes scored through an ADC
lookup table (counterpart of ``deeplearning4j_tpu/retrieval/pq.py``).

Split ``d`` into ``M`` subspaces, learn a ``ksub``-entry codebook per
subspace with :class:`KMeansClustering`, store ONE BYTE per subspace per
vector. Scoring is asymmetric distance computation (ADC): a matrix product
builds the query-to-codeword table

    LUT[b, m, j] = |q_m − c_{m,j}|²          (b, M, ksub)

and each stored vector's distance is the sum of its ``M`` codes' entries,

    d²(q, v) ≈ Σ_m LUT[b, m, code_m(v)]

which runs in the hand-written ``adc_pq`` / ``adc_ivf_pq`` kernels
(``perf/kernels/adc.py``; on a CPU tensor, their plain versions). The LUT,
the probe and the CSR slot arithmetic stay plain tensor code, as they stay
jnp around the JAX package's Pallas kernels.

- :class:`PQIndex` — flat ADC over the whole code table.
- :class:`IVFPQIndex` — IVF cells compose PQ over RESIDUALS vs the cell
  centroid, codes in the CSR flat layout (cell-major codes + offsets), a
  LUT per probed cell from the recentered query.
- ``rerank=r`` — the device answers the top ``r·k`` ADC candidates and a
  host pass re-scores them against the fp32 table kept on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.perf.kernels import adc
from deeplearning4j_tpu_torch.retrieval.index import (_DeviceIndex, _as_tensor,
                                                      _centroid_d2, _csr_slots,
                                                      _nbytes, _pow2ceil,
                                                      _topk_smallest,
                                                      _train_cells)

__all__ = ["PQCodec", "PQIndex", "IVFPQIndex", "assemble_pq_index",
           "assemble_ivf_pq_index"]

_ENCODE_CHUNK = 16384


# ---------------------------------------------------------------- scoring
def _adc_lut(qr: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """|q_m − c_{m,j}|² for every (query, subspace, codeword):
    ``qr`` (b, M, dsub) × ``codebooks`` (M, ksub, dsub) → (b, M, ksub), in
    the expanded form (no (b, M, ksub, dsub) difference tensor)."""
    cn2 = (codebooks * codebooks).sum(2)                   # (M, ksub)
    dots = torch.einsum("bmd,mkd->bmk", qr, codebooks)
    qn2 = (qr * qr).sum(2)[..., None]                      # (b, M, 1)
    return cn2[None] - 2.0 * dots + qn2


def _encode_chunk(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace for a chunk: (c, M, dsub) → (c, M)
    uint8 codes (first index on ties, as ``jnp.argmin``)."""
    return torch.argmin(_adc_lut(x, codebooks), dim=2).to(torch.uint8)


def _score_pq(q, codebooks, codes, k: int):
    """Flat ADC: LUT once per query, the gather-accumulate in ``adc_pq``,
    then the tie-stable top-k."""
    b = q.shape[0]
    m_count, _, dsub = codebooks.shape
    lut = _adc_lut(q.reshape(b, m_count, dsub), codebooks)
    d2 = adc.adc_pq(lut, codes)
    vals, idx = _topk_smallest(d2, k)
    return torch.sqrt(torch.clamp_min(vals, 0.0)), idx


def _score_ivf_pq(q, centroids, codebooks, flat_codes, flat_ids, offsets,
                  k: int, nprobe: int, cand_pad: int):
    """IVF-PQ over residuals in the CSR layout: probe, one LUT per probed
    cell from the recentered query, CSR slots, the per-slot
    gather-accumulate in ``adc_ivf_pq``, then invalid slots to inf, ids and
    the tie-stable top-k."""
    b = q.shape[0]
    m_count, ksub, dsub = codebooks.shape
    cd2 = _centroid_d2(q, centroids)
    _, probe = _topk_smallest(cd2, nprobe)                 # (b, p)
    qc = q[:, None, :] - centroids[probe]                  # (b, p, d)
    lut = _adc_lut(qc.reshape(b * nprobe, m_count, dsub),
                   codebooks).reshape(b, nprobe, m_count, ksub)
    seg, pos, valid = _csr_slots(offsets, probe, cand_pad)
    d2 = adc.adc_ivf_pq(lut, flat_codes, seg, pos)
    d2 = torch.where(valid, d2, torch.full((), float("inf"), device=d2.device))
    ids = torch.where(valid, flat_ids[pos.long()],
                      torch.full((), -1, dtype=flat_ids.dtype, device=d2.device))
    vals, p2 = _topk_smallest(d2, k)
    took = torch.gather(ids, 1, p2)
    return torch.sqrt(torch.clamp_min(vals, 0.0)), took


# ----------------------------------------------------------------- codec
class PQCodec:
    """Per-subspace codebooks + encoder. ``train`` runs one K-Means per
    subspace (``ksub`` codewords, 1 byte each, seeds ``seed + m``);
    ``encode`` assigns codes in fixed-size chunks on the codec's device."""

    def __init__(self, M: int, ksub: int = 256, *, seed: int = 123,
                 max_iterations: int = 25, device=None):
        if M < 1:
            raise ValueError(f"M must be >= 1; got {M}")
        if not 2 <= int(ksub) <= 256:
            raise ValueError(f"ksub must be in [2, 256] (codes are one "
                             f"byte); got {ksub}")
        self.M = int(M)
        self.ksub = int(ksub)
        self.seed = int(seed)
        self.max_iterations = int(max_iterations)
        self.device = resolve_device(device)
        self.dsub: Optional[int] = None
        self.codebooks: Optional[np.ndarray] = None  # (M, ksub_eff, dsub)

    def train(self, sample) -> "PQCodec":
        s = np.asarray(sample, np.float32)
        if s.ndim != 2 or not len(s):
            raise ValueError(f"PQ training sample must be (t, d); got "
                             f"shape {s.shape}")
        d = s.shape[1]
        if d % self.M:
            raise ValueError(
                f"M={self.M} subspaces must divide d={d} evenly — pick an "
                "M that divides the embedding width")
        self.dsub = d // self.M
        ksub_eff = min(self.ksub, len(s))
        books = []
        for m in range(self.M):
            km = KMeansClustering(ksub_eff,
                                  max_iterations=self.max_iterations,
                                  seed=self.seed + m, device=self.device)
            km.apply_to(s[:, m * self.dsub:(m + 1) * self.dsub])
            books.append(km.centroids.astype(np.float32))
        self.codebooks = np.stack(books)
        return self

    @classmethod
    def _from_codebooks(cls, codebooks: np.ndarray, *, seed: int = 123,
                        max_iterations: int = 25, device=None) -> "PQCodec":
        cb = np.asarray(codebooks, np.float32)
        codec = cls(cb.shape[0], max(2, cb.shape[1]), seed=seed,
                    max_iterations=max_iterations, device=device)
        codec.dsub = int(cb.shape[2])
        codec.codebooks = cb
        return codec

    def encode(self, vecs, chunk: int = _ENCODE_CHUNK) -> np.ndarray:
        """(n, d) → (n, M) uint8 codes, chunked so the build never holds
        more than one (chunk, M, ksub) LUT on the device."""
        if self.codebooks is None:
            raise ValueError("codec is not trained")
        v = np.asarray(vecs, np.float32)
        cb = _as_tensor(self.codebooks, self.device)
        out = np.empty((len(v), self.M), np.uint8)
        for lo in range(0, len(v), chunk):
            c = _as_tensor(v[lo:lo + chunk], self.device)
            x = c.reshape(len(c), self.M, self.dsub)
            out[lo:lo + len(c)] = _encode_chunk(x, cb).cpu().numpy()
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """fp32 reconstruction of encoded vectors (host-side)."""
        c = np.asarray(codes)
        return np.concatenate([self.codebooks[m][c[:, m]]
                               for m in range(self.M)], axis=1)

    def distortion(self, vecs, codes) -> float:
        """Mean squared reconstruction error per vector."""
        v = np.asarray(vecs, np.float32)
        rec = self.decode(codes)
        return float(np.mean(np.sum((v - rec) ** 2, axis=1)))


def _check_pq_kwargs(kwargs):
    if kwargs.get("metric", "euclidean") != "euclidean":
        raise ValueError("PQ indexes support euclidean only "
                         "(codebooks are euclidean centroids)")
    if kwargs.pop("int8", False) or kwargs.pop("int4", False):
        raise ValueError("PQ is its own codec — int8/int4 do not "
                         "compose with PQ codes")


# -------------------------------------------------------------- PQIndex
class PQIndex(_DeviceIndex):
    """Flat PQ: the whole corpus as (n, M) uint8 codes + (M, ksub, dsub)
    codebooks on the device — M bytes/vector against 4d fp32 — scored by
    ``adc_pq``. ``rerank=r`` re-scores the top r·k candidates exactly
    against the host-side fp32 table."""

    kind = "pq"

    def __init__(self, vectors, *, M: int = 8, ksub: int = 256,
                 rerank: int = 0, train_size: int = 100_000,
                 max_iterations: int = 25, seed: int = 123, **kwargs):
        _check_pq_kwargs(kwargs)
        self.M = int(M)
        self.ksub = int(ksub)
        self.train_size = int(train_size)
        self.max_iterations = int(max_iterations)
        self.seed = int(seed)
        super().__init__(vectors, rerank=rerank, **kwargs)

    @property
    def codec(self) -> str:
        return "pq"

    def _build(self, v: np.ndarray):
        if v.shape[1] % self.M:
            raise ValueError(f"M={self.M} subspaces must divide "
                             f"d={v.shape[1]} evenly")
        rng = np.random.default_rng(self.seed)
        if len(v) > self.train_size:
            sample = v[rng.choice(len(v), self.train_size, replace=False)]
        else:
            sample = v
        codec = PQCodec(self.M, self.ksub, seed=self.seed,
                        max_iterations=self.max_iterations, device=self.device)
        codec.train(sample)
        codes = codec.encode(v)
        # distortion on a seeded uniform subsample
        probe = rng.choice(len(v), min(len(v), 4096), replace=False)
        self.pq_distortion = codec.distortion(v[probe], codes[probe])
        self._finish(codec, codes)

    def _finish(self, codec: PQCodec, codes: np.ndarray):
        self.pq = codec
        self._codes = _as_tensor(np.asarray(codes, np.uint8), self.device)
        self._codebooks = _as_tensor(codec.codebooks, self.device)

    def _candidates(self) -> int:
        return self.size

    def _search_device(self, q, k: int):
        return _score_pq(q, self._codebooks, self._codes, k)

    def memory_bytes(self) -> int:
        return _nbytes(self._codes) + _nbytes(self._codebooks)

    def code_bytes(self) -> int:
        return _nbytes(self._codes)

    def stats(self) -> dict:
        st = super().stats()
        st.update(M=self.M, ksub=int(self._codebooks.shape[1]),
                  dsub=int(self._codebooks.shape[2]),
                  pq_distortion=self.pq_distortion)
        return st

    def _meta(self) -> dict:
        m = super()._meta()
        m.update(M=self.M, ksub=self.ksub,
                 train_size=self.train_size, seed=self.seed,
                 max_iterations=self.max_iterations,
                 pq_distortion=self.pq_distortion)
        return m

    def _arrays(self) -> dict:
        return {"codes": self._codes, "codebooks": self._codebooks}

    @classmethod
    def load(cls, path: str, device=None) -> "PQIndex":
        from deeplearning4j_tpu_torch.retrieval.index import _load_as
        return _load_as(cls, path, device)


# ----------------------------------------------------------- IVFPQIndex
class IVFPQIndex(_DeviceIndex):
    """IVF cells composing PQ over residuals, stored CSR-flat: cell-major
    (n, M) codes + offsets, probed and gathered by the CSR segment
    arithmetic, scored by ``adc_ivf_pq`` through a per-probed-cell LUT
    over the recentered query."""

    kind = "ivf_pq"

    def __init__(self, vectors, *, n_cells: Optional[int] = None,
                 nprobe: int = 8, M: int = 8, ksub: int = 256,
                 rerank: int = 0, train_size: int = 100_000,
                 max_iterations: int = 25, seed: int = 123, **kwargs):
        _check_pq_kwargs(kwargs)
        n = int(np.asarray(vectors).shape[0])
        self.n_cells = (max(1, int(round(n ** 0.5))) if n_cells is None
                        else int(n_cells))
        if self.n_cells > n:
            raise ValueError(f"n_cells={self.n_cells} exceeds corpus "
                             f"size {n}")
        self.nprobe = min(int(nprobe), self.n_cells)
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1; got {nprobe}")
        self.M = int(M)
        self.ksub = int(ksub)
        self.train_size = int(train_size)
        self.max_iterations = int(max_iterations)
        self.seed = int(seed)
        super().__init__(vectors, rerank=rerank, **kwargs)

    @property
    def codec(self) -> str:
        return "pq"

    def _build(self, v: np.ndarray):
        if v.shape[1] % self.M:
            raise ValueError(f"M={self.M} subspaces must divide "
                             f"d={v.shape[1]} evenly")
        centroids, assign = _train_cells(v, self.n_cells, self.train_size,
                                         self.max_iterations, self.seed,
                                         self.device)
        res = v - centroids[assign]
        rng = np.random.default_rng(self.seed)
        if len(res) > self.train_size:
            sample = res[rng.choice(len(res), self.train_size,
                                    replace=False)]
        else:
            sample = res
        codec = PQCodec(self.M, self.ksub, seed=self.seed,
                        max_iterations=self.max_iterations, device=self.device)
        codec.train(sample)
        codes = codec.encode(res)
        probe = rng.choice(len(res), min(len(res), 4096), replace=False)
        self.pq_distortion = codec.distortion(res[probe], codes[probe])
        counts = np.bincount(assign, minlength=self.n_cells)
        order = np.argsort(assign, kind="stable")
        self._finish(codec, codes, counts, order, centroids)

    def _finish(self, codec: PQCodec, codes: np.ndarray,
                counts: np.ndarray, order: np.ndarray,
                centroids: np.ndarray):
        self.pq = codec
        self.cell_counts = counts
        self.cap = max(1, int(counts.max()))
        # the per-query candidate axis covers the nprobe FULLEST cells
        worst = int(np.sort(counts)[-self.nprobe:].sum())
        self.cand_pad = _pow2ceil(max(1, worst))
        dev = self.device
        self._centroids = _as_tensor(np.asarray(centroids, np.float32), dev)
        self._codebooks = _as_tensor(codec.codebooks, dev)
        self._flat_codes = _as_tensor(np.asarray(codes, np.uint8)[order], dev)
        self._flat_ids = _as_tensor(order.astype(np.int32), dev)
        self._offsets = _as_tensor(np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int32), dev)

    def _candidates(self) -> int:
        return min(self.size, self.cand_pad)

    def _search_device(self, q, k: int):
        return _score_ivf_pq(q, self._centroids, self._codebooks,
                             self._flat_codes, self._flat_ids,
                             self._offsets, k, self.nprobe, self.cand_pad)

    def memory_bytes(self) -> int:
        return (_nbytes(self._flat_codes) + _nbytes(self._codebooks)
                + _nbytes(self._centroids) + _nbytes(self._flat_ids)
                + _nbytes(self._offsets))

    def code_bytes(self) -> int:
        return _nbytes(self._flat_codes)

    def stats(self) -> dict:
        st = super().stats()
        st.update(M=self.M, ksub=int(self._codebooks.shape[1]),
                  dsub=int(self._codebooks.shape[2]),
                  n_cells=self.n_cells, nprobe=self.nprobe, cap=self.cap,
                  layout="csr", cand_pad=self.cand_pad,
                  empty_cells=int((self.cell_counts == 0).sum()),
                  pq_distortion=self.pq_distortion)
        return st

    def _meta(self) -> dict:
        m = super()._meta()
        m.update(M=self.M, ksub=self.ksub,
                 n_cells=self.n_cells, nprobe=self.nprobe, cap=self.cap,
                 cand_pad=self.cand_pad, train_size=self.train_size,
                 seed=self.seed, max_iterations=self.max_iterations,
                 pq_distortion=self.pq_distortion)
        return m

    def _arrays(self) -> dict:
        return {"centroids": self._centroids,
                "codebooks": self._codebooks,
                "flat_codes": self._flat_codes,
                "flat_ids": self._flat_ids,
                "offsets": self._offsets,
                "cell_counts": self.cell_counts}

    @classmethod
    def load(cls, path: str, device=None) -> "IVFPQIndex":
        from deeplearning4j_tpu_torch.retrieval.index import _load_as
        return _load_as(cls, path, device)


# ------------------------------------------------------------- assembly
# (the streaming builder's seam: construct an index from already-encoded
# codes WITHOUT the fp32 matrix ever existing in one piece)

def _bare(cls, *, size, dim, labels, seed, train_size, max_iterations,
          M, ksub, distortion, device):
    idx = cls.__new__(cls)
    idx._restore_common({"metric": "euclidean", "size": int(size),
                         "dim": int(dim), "int8": False, "int4": False,
                         "observer": "minmax", "scale": None,
                         "labels": labels}, device=device)
    idx.M = int(M)
    idx.ksub = int(ksub)
    idx.train_size = int(train_size)
    idx.seed = int(seed)
    idx.max_iterations = int(max_iterations)
    idx.pq_distortion = distortion
    return idx


def assemble_pq_index(codec: PQCodec, codes: np.ndarray, *, size, dim,
                      labels=None, distortion=None, seed=123,
                      train_size=100_000, max_iterations=25,
                      device=None) -> "PQIndex":
    idx = _bare(PQIndex, size=size, dim=dim, labels=labels, seed=seed,
                train_size=train_size, max_iterations=max_iterations,
                M=codec.M, ksub=codec.ksub, distortion=distortion,
                device=device)
    idx._finish(codec, codes)
    return idx


def assemble_ivf_pq_index(codec: PQCodec, codes: np.ndarray,
                          assign: np.ndarray, centroids: np.ndarray, *,
                          nprobe=8, size, dim, labels=None,
                          distortion=None, seed=123, train_size=100_000,
                          max_iterations=25, device=None) -> "IVFPQIndex":
    idx = _bare(IVFPQIndex, size=size, dim=dim, labels=labels, seed=seed,
                train_size=train_size, max_iterations=max_iterations,
                M=codec.M, ksub=codec.ksub, distortion=distortion,
                device=device)
    idx.n_cells = int(len(centroids))
    idx.nprobe = min(int(nprobe), idx.n_cells)
    counts = np.bincount(assign, minlength=idx.n_cells)
    order = np.argsort(assign, kind="stable")
    idx._finish(codec, codes, counts, order, centroids)
    return idx


# ----------------------------------------------------------- persistence
def _load_pq(kind: str, meta: dict, arrays: dict, device=None) -> "_DeviceIndex":
    """``load_index`` dispatch target for the PQ kinds."""
    cls = PQIndex if kind == "pq" else IVFPQIndex
    idx = cls.__new__(cls)
    idx._restore_common(meta, arrays, device)
    idx.M = int(meta["M"])
    idx.ksub = int(meta["ksub"])
    idx.train_size = int(meta.get("train_size", 100_000))
    idx.seed = int(meta.get("seed", 123))
    idx.max_iterations = int(meta.get("max_iterations", 25))
    idx.pq_distortion = meta.get("pq_distortion")
    codec = PQCodec._from_codebooks(arrays["codebooks"], seed=idx.seed,
                                    max_iterations=idx.max_iterations,
                                    device=idx.device)
    if kind == "pq":
        idx._finish(codec, arrays["codes"])
    else:
        idx.n_cells = int(meta["n_cells"])
        idx.nprobe = int(meta["nprobe"])
        # _finish flattens id-order codes through `order`; the npz holds
        # the already-flattened table, so scatter it back first
        counts = arrays["cell_counts"]
        order = np.asarray(arrays["flat_ids"]).astype(np.int64)
        codes_orig = np.empty_like(arrays["flat_codes"])
        codes_orig[order] = arrays["flat_codes"]
        idx._finish(codec, codes_orig, counts, order,
                    arrays["centroids"])
    return idx
