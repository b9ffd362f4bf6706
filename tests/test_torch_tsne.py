"""The port's t-SNE against the JAX package's, on the CPU.

- The numpy helpers (perplexity calibration over full and kNN distances,
  the sparse symmetrization) are the JAX package's code: bitwise.
- ``_knn_graph``: the same neighbour ids in the same order (ascending
  distance, ties lower index first), distances within 1e-6 of
  |a|^2 + |b|^2 (the expanded form cancels); the tiling (row tiles and column chunks smaller than n) does
  not change the answer.
- One exact step and one approximate (kNN + grid-centroid) step from the
  same given state: the new embedding within 1e-5 of its largest
  magnitude, gains equal, KL within rtol 1e-5 (torch and XLA sum the same
  products in other orders).
- A short fit (20 iterations, both regimes) from one given initial state,
  the JAX package's threefry draw: the embedding within 1e-4 of its
  largest magnitude and every recorded KL within rtol 1e-5. Longer runs
  are not compared: the sign-driven gains amplify rounding differences
  into different trajectories within about 30 iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.plot import tsne as J

from deeplearning4j_tpu_torch.plot import tsne as P


def _blobs(n_per=30, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([c + rng.standard_normal((n_per, dim))
                           for c in 6.0 * np.eye(3, dim)])


# small tiles for the JAX package's kNN: its default (2048, 8192) tiles
# take seconds to compile on the CPU at any n
JAX_TILES = dict(row_tile=32, col_chunk=64)


def test_numpy_helpers_bitwise():
    x = _blobs()
    p = P._conditional_probs(x, 8.0)
    assert p.tobytes() == J._conditional_probs(x, 8.0).tobytes()
    idx, d2 = J._knn_graph(x, 24, **JAX_TILES)
    kp = P._knn_probs(d2, 8.0)
    assert kp.tobytes() == J._knn_probs(d2, 8.0).tobytes()
    for a, b in zip(P._symmetrize_sparse(idx, kp), J._symmetrize_sparse(idx, kp)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("row_tile,col_chunk", [(2048, 8192), (16, 40)])
def test_knn_graph_ids_exact(row_tile, col_chunk):
    x = _blobs()
    want_i, want_d = J._knn_graph(x, 24, **JAX_TILES)
    got_i, got_d = P._knn_graph(x, 24, "cpu", row_tile=row_tile, col_chunk=col_chunk)
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    assert np.array_equal(got_i, want_i)
    # |a|^2 + |b|^2 - 2 a.b cancels: the error scales with the two norms
    sq = np.sum(x.astype(np.float32) ** 2, 1)
    assert (np.abs(got_d - want_d) <= 1e-6 * (sq[:, None] + sq[want_i])).all()
    # ties: a duplicated point's twin comes first at distance 0, lower index first
    dup = np.concatenate([x, x[:5]])
    got_i, _ = P._knn_graph(dup, 4, "cpu")
    want_i, _ = J._knn_graph(dup, 4, **JAX_TILES)
    assert np.array_equal(got_i, want_i) and got_i[0, 0] == 90


def _tol(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_exact_and_bh_steps_on_given_inputs():
    x = _blobs()
    n = x.shape[0]
    p = J._conditional_probs(x, 8.0)
    p = np.maximum((p + p.T) / (2.0 * n), 1e-12).astype(np.float32) * 12.0
    rng = np.random.default_rng(1)
    y = rng.standard_normal((n, 2)).astype(np.float32)
    gains = rng.uniform(0.5, 1.5, (n, 2)).astype(np.float32)
    vel = (0.1 * rng.standard_normal((n, 2))).astype(np.float32)
    jy, jgain, jvel, jkl = J._tsne_step(jnp.asarray(y), jnp.asarray(p), jnp.asarray(gains),
                                        jnp.asarray(vel), jnp.float32(0.5), jnp.float32(200.0))
    py, pgain, pvel, pkl = P._tsne_step(*(torch.tensor(a) for a in (y, p, gains, vel)),
                                        0.5, 200.0)
    _tol(py.numpy(), np.asarray(jy), 1e-5)
    _tol(pvel.numpy(), np.asarray(jvel), 1e-5)
    assert np.array_equal(pgain.numpy(), np.asarray(jgain))
    assert float(pkl) == pytest.approx(float(jkl), rel=1e-5)
    # the approximate step, on the kNN graph of x, with padding rows
    idx, d2 = J._knn_graph(x, 24, **JAX_TILES)
    nbr_idx, nbr_val = J._symmetrize_sparse(idx, J._knn_probs(d2, 8.0))
    n_pad, tile, grid = 128, 32, 8
    pad = ((0, n_pad - n), (0, 0))
    wpt = np.pad(np.ones(n, np.float32), (0, n_pad - n))
    y_pad = np.pad(y, pad)
    args = (y_pad, wpt, np.pad(nbr_idx, pad), np.pad(nbr_val, pad) * np.float32(12.0),
            np.pad(gains, pad, constant_values=1.0), np.pad(vel, pad))
    step = J._make_bh_step(n_pad, 2, grid, tile)
    jy, jgain, jvel, jkl = step(*(jnp.asarray(a) for a in args), jnp.float32(0.5),
                                jnp.float32(200.0))
    ta = [torch.tensor(a) for a in args]
    ta[2] = ta[2].long()
    py, pgain, pvel, pkl = P._bh_step(*ta, 0.5, 200.0, grid, tile)
    _tol(py.numpy()[:n], np.asarray(jy)[:n], 1e-5)
    assert np.array_equal(pgain.numpy()[:n], np.asarray(jgain)[:n])
    assert float(pkl) == pytest.approx(float(jkl), rel=1e-5)


@pytest.mark.parametrize("bh_threshold", [8192, 50])
def test_short_fit_from_a_given_initial_state(bh_threshold, monkeypatch):
    x = _blobs()
    n = x.shape[0]
    kw = dict(perplexity=8, max_iter=20, learning_rate=10.0, stop_lying_iteration=10,
              switch_momentum_iteration=15, seed=5, bh_threshold=bh_threshold, grid=16)
    knn = J._knn_graph  # the same neighbours at any tiling, compiled faster
    monkeypatch.setattr(J, "_knn_graph", lambda x, k: knn(x, k, **JAX_TILES))
    jt = J.BarnesHutTsne(**kw).fit(x)
    # the JAX package's initial draw: (n, 2), or (n_pad, 2) in the
    # approximate regime, whose first n rows are the points'
    rows = n if bh_threshold > n else 1024
    y0 = np.asarray(1e-4 * jax.random.normal(jax.random.key(5), (rows, 2), jnp.float32))[:n]
    pt = P.BarnesHutTsne(device="cpu", **kw).fit(x, init=y0)
    assert pt.get_data().shape == (n, 2) and np.isfinite(pt.get_data()).all()
    _tol(pt.get_data(), jt.get_data(), 1e-4)
    np.testing.assert_allclose(pt.kl_history, jt.kl_history, rtol=1e-5)
    with pytest.raises(ValueError, match="init"):
        P.BarnesHutTsne(device="cpu", **kw).fit(x, init=y0[:10])
    with pytest.raises(ValueError, match="[Pp]erplexity"):
        P.BarnesHutTsne(perplexity=30.0, device="cpu").fit(np.zeros((10, 3)))
