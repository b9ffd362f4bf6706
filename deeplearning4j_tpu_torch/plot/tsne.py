"""t-SNE embedding (counterpart of ``deeplearning4j_tpu/plot/tsne.py``).

Parity surface: reference ``deeplearning4j-core/.../plot/BarnesHutTsne.java:65``
(builder: theta, perplexity, maxIter, learningRate, momentum/finalMomentum,
stopLyingIteration; ``fit(INDArray)`` then ``getData()``), ``Tsne.java``, and
the approximation machinery ``sptree/SpTree.java:36`` / ``QuadTree.java``.

The same two regimes as the JAX package, each gradient iteration a short
sequence of torch operations on the model's device (``cuda`` unless
``device="cpu"`` is passed):

- **exact** (small/medium n, or ``theta == 0``): full (N, N) matrices, the
  van-der-Maaten update rules (momentum schedule, per-dimension gains,
  early exaggeration) elementwise;
- **approximate** (``theta > 0`` and n >= ``bh_threshold``): attractive
  forces over a sparse kNN graph (k = 3 * perplexity, the sparse P of
  BarnesHutTsne.java), built by a tiled streaming top-k over distance
  blocks; repulsive forces against the mass centroids of a fixed 64x64
  (2-D) grid of the current embedding, tiled over rows. Memory is
  O(n * k + cells) per iteration, never O(n^2).

The perplexity calibration and the sparse symmetrization are the JAX
package's numpy code, unchanged, so P is bitwise the same. Every matrix
product runs in full float32 (TF32 off, the JAX package's
``precision="highest"``); the grid's cell ids truncate the same float32
quotient in the same order. The grid's segment sums are ``index_add_``,
whose CUDA atomics add in no fixed order, so a step on the card agrees
with one on the CPU within rounding, not bitwise. The kNN ids follow
``lax.top_k``'s order (ties lower index first).

The initial embedding is ``1e-4 * N(0, 1)`` drawn from a
``torch.Generator`` seeded with ``seed``; JAX draws it from threefry, so
``fit(x, init=y0)`` takes a given initial state for a run that must
follow another package's.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["BarnesHutTsne", "Tsne"]


@contextlib.contextmanager
def _full_float32():
    """Matrix products in full float32 for the duration (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _conditional_probs(x: np.ndarray, perplexity: float,
                       tol: float = 1e-5, max_steps: int = 50) -> np.ndarray:
    """Row-stochastic P(j|i) matching the target perplexity via a vectorized
    binary search over per-point precision beta (BarnesHutTsne computes the
    same quantity serially per point in computeGaussianPerplexity)."""
    n = x.shape[0]
    d2 = np.sum(x**2, 1)[:, None] - 2.0 * (x @ x.T) + np.sum(x**2, 1)[None, :]
    np.fill_diagonal(d2, np.inf)
    log_target = np.log(perplexity)
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    p = np.zeros((n, n))
    for _ in range(max_steps):
        p = np.exp(-d2 * beta[:, None])
        psum = np.maximum(p.sum(1), 1e-12)
        # Shannon entropy of each row in nats (diagonal excluded: inf
        # distance -> p=0, so zero the product explicitly to avoid inf*0)
        d2p = np.where(np.isinf(d2), 0.0, d2) * p
        h = np.log(psum) + beta * np.sum(d2p, 1) / psum
        diff = h - log_target
        done = np.abs(diff) < tol
        if done.all():
            break
        too_high = diff > 0  # entropy too high -> increase beta
        beta_min = np.where(too_high & ~done, beta, beta_min)
        beta_max = np.where(~too_high & ~done, beta, beta_max)
        beta = np.where(
            too_high & ~done,
            np.where(np.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            np.where(~too_high & ~done,
                     np.where(np.isinf(beta_min), beta / 2, (beta + beta_min) / 2),
                     beta))
    p = p / np.maximum(p.sum(1, keepdims=True), 1e-12)
    return p


def _gains_momentum(grad, gains, velocity, momentum: float, lr: float):
    """Adaptive gains (grow when the gradient keeps its direction, shrink
    on flips) and the momentum update; returns (gains, velocity)."""
    same_sign = torch.sign(grad) == torch.sign(velocity)
    gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
    velocity = momentum * velocity - lr * gains * grad
    return gains, velocity


def _tsne_step(y, p, gains, velocity, momentum: float, lr: float):
    """One exact t-SNE gradient step + KL (van der Maaten 2008 eqns 4-5);
    ``y``, ``p``, ``gains``, ``velocity`` float32 tensors on one device."""
    n = y.shape[0]
    yyt = torch.matmul(y, y.T)
    d2 = torch.sum(y**2, 1, keepdim=True) - 2.0 * yyt + torch.sum(y**2, 1)
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    q = num / torch.clamp_min(torch.sum(num), 1e-12)
    pq = (p - q) * num
    grad = 4.0 * torch.matmul(torch.diag(pq.sum(1)) - pq, y)
    gains, velocity = _gains_momentum(grad, gains, velocity, momentum, lr)
    y = y + velocity
    y = y - torch.mean(y, 0)
    kl = torch.sum(torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-12)
                                                    / torch.clamp_min(q, 1e-12)),
                               0.0))
    return y, gains, velocity, kl


# ---------------------------------------------------------------------------
# Approximate (Barnes-Hut-equivalent) machinery

def _knn_graph(x: np.ndarray, k: int, device=None, row_tile: int = 2048,
               col_chunk: int = 8192):
    """Tiled k-nearest-neighbours on ``device``: returns (idx (n, k) int32,
    d2 (n, k) float32) host arrays. A streaming top-k over distance blocks
    in full float32 — memory is O(row_tile * col_chunk), never O(n^2) —
    with ``lax.top_k``'s order: ascending, ties lower index first."""
    from deeplearning4j_tpu_torch.retrieval.index import _topk_smallest
    device = resolve_device(device)
    n, _ = x.shape
    k = min(k, n - 1)
    xd = torch.as_tensor(np.asarray(x, np.float32), device=device)
    sq = torch.sum(xd * xd, 1)
    idx = np.zeros((n, k), np.int32)
    d2 = np.zeros((n, k), np.float32)
    with _full_float32():
        for r0 in range(0, n, row_tile):
            rows, rows_sq = xd[r0:r0 + row_tile], sq[r0:r0 + row_tile]
            t = rows.shape[0]
            best_d = torch.full((t, k), float("inf"), dtype=torch.float32, device=device)
            best_i = torch.zeros((t, k), dtype=torch.int64, device=device)
            row_ids = r0 + torch.arange(t, device=device)
            for c0 in range(0, n, col_chunk):
                cols, csq = xd[c0:c0 + col_chunk], sq[c0:c0 + col_chunk]
                dd = rows_sq[:, None] + csq[None, :] - 2.0 * torch.matmul(rows, cols.T)
                gcol = c0 + torch.arange(cols.shape[0], device=device)
                dd = torch.where(gcol[None, :] == row_ids[:, None], float("inf"), dd)
                cat_d = torch.cat([best_d, dd], 1)
                cat_i = torch.cat([best_i, gcol.expand(t, -1)], 1)
                best_d, pos = _topk_smallest(cat_d, k)
                best_i = cat_i.gather(1, pos)
            d2[r0:r0 + t] = best_d.cpu().numpy()
            idx[r0:r0 + t] = best_i.to(torch.int32).cpu().numpy()
    return idx, d2


def _knn_probs(d2: np.ndarray, perplexity: float, tol: float = 1e-5,
               max_steps: int = 50) -> np.ndarray:
    """Row-stochastic P(j|i) over the kNN distances only (the sparse P of
    BarnesHutTsne.java computeGaussianPerplexity with its VPTree kNN)."""
    n, k = d2.shape
    log_target = np.log(min(perplexity, k))
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    d2 = d2 - d2[:, :1]  # shift for numerical stability (exp overflow)
    p = np.zeros_like(d2)
    for _ in range(max_steps):
        p = np.exp(-d2 * beta[:, None])
        psum = np.maximum(p.sum(1), 1e-12)
        h = np.log(psum) + beta * np.sum(d2 * p, 1) / psum
        diff = h - log_target
        done = np.abs(diff) < tol
        if done.all():
            break
        too_high = diff > 0
        beta_min = np.where(too_high & ~done, beta, beta_min)
        beta_max = np.where(~too_high & ~done, beta, beta_max)
        beta = np.where(
            too_high & ~done,
            np.where(np.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            np.where(~too_high & ~done,
                     np.where(np.isinf(beta_min), beta / 2, (beta + beta_min) / 2),
                     beta))
    return p / np.maximum(p.sum(1, keepdims=True), 1e-12)


def _symmetrize_sparse(idx: np.ndarray, p: np.ndarray):
    """(P + P^T) / 2n over sparse COO, repacked to padded per-row lists.
    Returns (nbr_idx (n, K2) int32, nbr_val (n, K2) float32).

    K2 is capped at 3k: kNN *hub* points can be reverse-neighbours of
    thousands of rows, and padding every row to the hub width explodes
    memory. Rows over the cap keep their largest-p entries — the dropped
    tail is the smallest conditional probabilities, negligible attractive
    mass."""
    n, k = idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.reshape(-1).astype(np.int64)
    vals = p.reshape(-1) / (2.0 * n)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals])
    key = r * n + c
    order = np.argsort(key, kind="stable")
    key, v = key[order], v[order]
    uniq, start = np.unique(key, return_index=True)
    summed = np.add.reduceat(v, start)
    ur = (uniq // n).astype(np.int64)
    uc = (uniq % n).astype(np.int32)
    # order by (row, -value) so per-row slots are value-sorted
    order2 = np.lexsort((-summed, ur))
    ur, uc, summed = ur[order2], uc[order2], summed[order2]
    counts = np.bincount(ur, minlength=n)
    cap = 3 * k
    K2 = int(min(counts.max(), cap))
    # within-row position of each entry, vectorized (a per-row arange
    # concat is O(n) python objects at the large n this path exists for)
    slot = (np.arange(counts.sum(), dtype=np.int64)
            - np.repeat(np.cumsum(counts, dtype=np.int64) - counts, counts))
    keep = slot < K2
    nbr_idx = np.zeros((n, K2), np.int32)
    nbr_val = np.zeros((n, K2), np.float32)
    nbr_idx[ur[keep], slot[keep]] = uc[keep]
    nbr_val[ur[keep], slot[keep]] = summed[keep]
    return nbr_idx, nbr_val


def _bh_step(y, wpt, nbr_idx, nbr_val, gains, velocity, momentum: float, lr: float,
             grid: int, row_tile: int):
    """One approximate gradient step + the approximate KL. Points are
    padded to a multiple of ``row_tile`` with a 0/1 weight vector ``wpt``;
    the repulsive field is evaluated against the mass centroids of a
    grid^dim cell decomposition of the current embedding."""
    n_pad, dim = y.shape
    cells = grid ** dim
    # ---- attractive: sparse kNN pairs, O(n*k)
    yj = y[nbr_idx]                                    # (n, K2, dim)
    diff = y[:, None, :] - yj
    w = 1.0 / (1.0 + torch.sum(diff * diff, -1))       # (n, K2)
    f_attr = torch.einsum("nk,nkd->nd", nbr_val * w, diff)
    # ---- repulsive: grid-centroid far field, O(n*cells) tiled
    big = 1e9
    live = wpt[:, None] > 0
    mn = torch.min(torch.where(live, y, big), 0).values  # pads out of range
    mx = torch.max(torch.where(live, y, -big), 0).values
    span = torch.clamp_min(mx - mn, 1e-9)
    cellc = torch.clamp(((y - mn) / span * grid).to(torch.int32), 0, grid - 1)
    cid = cellc[:, 0]
    for d in range(1, dim):
        cid = cid * grid + cellc[:, d]
    cid = torch.where(wpt > 0, cid, cells - 1).to(torch.int64)
    m = torch.zeros(cells, dtype=y.dtype, device=y.device).index_add_(0, cid, wpt)
    s = torch.zeros((cells, dim), dtype=y.dtype, device=y.device).index_add_(
        0, cid, y * wpt[:, None])
    mu = s / torch.clamp_min(m, 1.0)[:, None]
    zs, fs = [], []
    for t0 in range(0, n_pad, row_tile):
        dif = y[t0:t0 + row_tile, None, :] - mu[None, :, :]   # (T, cells, dim)
        wq = 1.0 / (1.0 + torch.sum(dif * dif, -1))            # (T, cells)
        zs.append(torch.sum(wq * m[None, :], 1) - 1.0)         # minus self w_ii
        fs.append(torch.einsum("tc,tcd->td", wq * wq * m[None, :], dif))
    z = torch.clamp_min(torch.sum(torch.cat(zs) * wpt), 1e-12)
    f_rep = torch.cat(fs)
    grad = 4.0 * (f_attr - f_rep / z)
    grad = grad * wpt[:, None]
    gains, velocity = _gains_momentum(grad, gains, velocity, momentum, lr)
    y = y + velocity * wpt[:, None]
    npts = torch.clamp_min(torch.sum(wpt), 1.0)
    y = y - (torch.sum(y * wpt[:, None], 0) / npts)
    # approximate KL over the stored neighbour pairs
    q = torch.clamp_min(w / z, 1e-12)
    kl = torch.sum(torch.where(nbr_val > 0,
                               nbr_val * torch.log(torch.clamp_min(nbr_val, 1e-12) / q),
                               0.0))
    return y, gains, velocity, kl


class BarnesHutTsne:
    """t-SNE with the reference's builder surface: exact for small n (or
    theta=0), kNN + grid-centroid approximation (the reference's Barnes-Hut
    regime) for large n. Runs on ``device`` (``cuda`` unless
    ``device="cpu"`` is passed)."""

    def __init__(self, num_dimensions: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, max_iter: int = 1000,
                 learning_rate: float = 200.0, momentum: float = 0.5,
                 final_momentum: float = 0.8, switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 250, exaggeration: float = 12.0,
                 seed: int = 123, bh_threshold: int = 8192,
                 grid: int = 0, device=None):
        self.num_dimensions = num_dimensions
        self.perplexity = perplexity
        # theta == 0 forces exact gradients at any n (reference semantics);
        # theta > 0 selects the approximate regime once n >= bh_threshold
        self.theta = theta
        self.bh_threshold = bh_threshold
        self.grid = grid or (64 if num_dimensions <= 2 else 16)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.embedding: Optional[np.ndarray] = None
        self.kl_history: list = []

    def _initial(self, n: int, n_rows: int, init) -> torch.Tensor:
        """(n_rows, dim) float32 starting embedding: ``init`` (n, dim) when
        given, else ``1e-4 * N(0, 1)`` from a generator seeded with
        ``seed``; rows past ``n`` (padding) are zero."""
        dim = self.num_dimensions
        y = torch.zeros((n_rows, dim), dtype=torch.float32, device=self.device)
        if init is not None:
            init = np.asarray(init, np.float32)
            if init.shape != (n, dim):
                raise ValueError(f"init must be ({n}, {dim}), got {init.shape}")
            y[:n] = torch.as_tensor(init, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            y[:n] = 1e-4 * torch.randn((n, dim), generator=gen, device=self.device)
        return y

    def _schedule(self, it: int):
        lying = it < self.stop_lying_iteration
        mom = (self.momentum if it < self.switch_momentum_iteration
               else self.final_momentum)
        return lying, mom

    def _record(self, it: int) -> bool:
        return it % 50 == 0 or it == self.max_iter - 1

    def fit(self, x, init=None) -> "BarnesHutTsne":
        """Embed ``x`` (n, d). ``init`` (n, num_dimensions) replaces the
        seeded initial embedding."""
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if n - 1 < 3 * self.perplexity:
            raise ValueError(
                f"Perplexity {self.perplexity} too large for {n} points "
                "(need n-1 >= 3*perplexity)")
        if self.theta > 0 and n >= self.bh_threshold:
            return self._fit_bh(x, init)
        p = _conditional_probs(x, self.perplexity)
        p = (p + p.T) / (2.0 * n)          # symmetrize, joint distribution
        p = np.maximum(p, 1e-12)
        p_dev = torch.as_tensor(p.astype(np.float32), device=self.device)
        p_lying = p_dev * self.exaggeration
        y = self._initial(n, n, init)
        gains = torch.ones_like(y)
        velocity = torch.zeros_like(y)
        self.kl_history = []
        with _full_float32():
            for it in range(self.max_iter):
                lying, mom = self._schedule(it)
                y, gains, velocity, kl = _tsne_step(
                    y, p_lying if lying else p_dev, gains, velocity,
                    mom, self.learning_rate)
                if self._record(it):
                    self.kl_history.append(float(kl))
        self.embedding = y.cpu().numpy()
        return self

    def _fit_bh(self, x: np.ndarray, init=None) -> "BarnesHutTsne":
        """Approximate regime: sparse kNN attraction + grid-centroid
        repulsion (see module docstring). Memory O(n*k + cells)."""
        n = x.shape[0]
        k = max(3, int(3 * self.perplexity))
        idx, d2 = _knn_graph(x, k, self.device)
        p_cond = _knn_probs(d2, self.perplexity)
        nbr_idx, nbr_val = _symmetrize_sparse(idx, p_cond)
        row_tile = 1024
        n_pad = -(-n // row_tile) * row_tile
        dev = self.device
        y = self._initial(n, n_pad, init)
        wpt = torch.as_tensor(np.pad(np.ones(n, np.float32), (0, n_pad - n)), device=dev)
        nbr_idx_d = torch.as_tensor(np.pad(nbr_idx, ((0, n_pad - n), (0, 0))),
                                    device=dev).to(torch.int64)
        val_np = np.pad(nbr_val, ((0, n_pad - n), (0, 0)))
        val_plain = torch.as_tensor(val_np, device=dev)
        val_lying = torch.as_tensor(val_np * np.float32(self.exaggeration), device=dev)
        gains = torch.ones_like(y)
        velocity = torch.zeros_like(y)
        self.kl_history = []
        with _full_float32():
            for it in range(self.max_iter):
                lying, mom = self._schedule(it)
                y, gains, velocity, kl = _bh_step(
                    y, wpt, nbr_idx_d, val_lying if lying else val_plain,
                    gains, velocity, mom, self.learning_rate, self.grid, row_tile)
                if self._record(it):
                    self.kl_history.append(float(kl))
        self.embedding = y[:n].cpu().numpy()
        return self

    def fit_transform(self, x) -> np.ndarray:
        return self.fit(x).get_data()

    def get_data(self) -> np.ndarray:
        """The learned embedding (reference BarnesHutTsne.getData)."""
        if self.embedding is None:
            raise ValueError("fit() first")
        return self.embedding


# The reference also ships a plain exact Tsne (plot/Tsne.java); this one is
# exact already, so the names coincide.
Tsne = BarnesHutTsne
