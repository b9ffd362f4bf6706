"""The port's ``IVFIndex`` against the JAX package's, on the CPU.

IVF indexes the JAX package built (dense and CSR cells; float32, int8 and
int4 residual codes) cross to the port as the ``.npz`` their ``save()``
writes and answer the same queries; the port's ``save()`` loads back into
the JAX package. Cells the port builds itself (its K-Means on the same
seeded subsample) are held against the JAX package's cells and recall.
Inputs come from numpy with fixed seeds.

Tolerances: ids equal. d² = |q|² − 2·q·v + |v|² cancels large addends, and
torch and XLA sum the products in another order, so distances are held as
d² within 8 ulps of |q|² + max |v|² (the magnitude the addends cancel
from). Centroids within 1e-4 absolute; the port's recall@10 within 0.01 of
the JAX package's on the same corpus.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ivf.py`` measures the
JAX package's IVF recall@10 at ``chip_smoke.py``'s retrieval configuration:
the reference for the card's IVF recall gates.
"""

import os
import time

import numpy as np
import pytest

from deeplearning4j_tpu import retrieval as jr

from deeplearning4j_tpu_torch import retrieval as pr
from deeplearning4j_tpu_torch.retrieval import IndexEndpoint

VARIANTS = {
    "dense": {}, "csr": {"layout": "csr"},
    "dense_int8": {"int8": True}, "csr_int8": {"int8": True, "layout": "csr"},
    "dense_int4": {"int4": True}, "csr_int4": {"int4": True, "layout": "csr"},
}
IVF_KW = dict(n_cells=12, nprobe=3)
ULPS = 8


@pytest.fixture(scope="module")
def corpus():
    return pr.synthetic_corpus(1200, 16, n_clusters=15, seed=0, queries=20)


@pytest.fixture(scope="module")
def exact(corpus):
    V, Q = corpus
    return pr.BruteForceIndex(V, device="cpu").search(Q, 10)[0]


def _hold_distances(pd, jd, Q, V):
    assert np.array_equal(np.isinf(pd), np.isinf(jd))
    fin = np.isfinite(jd)
    mag = (Q.astype(np.float64) ** 2).sum(1, keepdims=True) + float((V ** 2).sum(1).max())
    tol = ULPS * np.spacing(mag.astype(np.float32)).astype(np.float64)
    err = np.abs(pd.astype(np.float64) ** 2 - jd.astype(np.float64) ** 2)
    assert np.all(err[fin] <= np.broadcast_to(tol, err.shape)[fin]), float(err[fin].max())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_saved_index_answers_the_same(corpus, tmp_path, variant):
    V, Q = corpus
    jix = jr.IVFIndex(V, **IVF_KW, **VARIANTS[variant])
    pix = pr.load_index(jix.save(str(tmp_path / "ivf.npz")), device="cpu")
    assert isinstance(pix, pr.IVFIndex) and pix.layout == jix.layout
    for k in (1, 10):
        ji, jd = jix.search(Q, k)
        pi, pd = pix.search(Q, k)
        assert np.array_equal(pi, ji), (variant, k)
        _hold_distances(pd, jd, Q, V)
    one = pix.search(Q[3], 5)
    assert np.array_equal(one[0], jix.search(Q[3], 5)[0])
    js, ps = jix.stats(), pix.stats()
    for key in ("kind", "size", "dim", "codec", "scale", "memory_bytes", "code_bytes",
                "n_cells", "nprobe", "cap", "layout", "empty_cells"):
        assert ps[key] == js[key], key
    assert pix.max_k == jix.max_k
    # and back: the port's save() loads into the JAX package
    back = jr.load_index(pix.save(str(tmp_path / "back.npz")))
    assert np.array_equal(back.search(Q, 10)[0], jix.search(Q, 10)[0])


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_port_built_cells_and_recall(corpus, exact, codec):
    V, Q = corpus
    kw = {"fp32": {}, "int8": {"int8": True}, "int4": {"int4": True}}[codec]
    jix = jr.IVFIndex(V, **IVF_KW, **kw)
    dense = pr.IVFIndex(V, **IVF_KW, device="cpu", **kw)
    csr = pr.IVFIndex(V, **IVF_KW, layout="csr", device="cpu", **kw)
    np.testing.assert_allclose(dense._centroids.numpy(), np.asarray(jix._centroids),
                               atol=1e-4, rtol=0)
    assert np.array_equal(dense.cell_counts, jix.cell_counts) and dense.cap == jix.cap
    assert dense.scale == pytest.approx(jix.scale, rel=1e-6) if jix.scale else True
    di, dd = dense.search(Q, 10)
    ci, cd = csr.search(Q, 10)
    assert np.array_equal(di, ci) and np.array_equal(dd, cd)   # layouts agree exactly
    recall = np.mean([len(np.intersect1d(g, w)) / 10 for g, w in zip(di, exact)])
    jrec = np.mean([len(np.intersect1d(g, w)) / 10
                    for g, w in zip(jix.search(Q, 10)[0], exact)])
    assert recall >= jrec - 0.01 and recall > 0.5, (recall, jrec)
    assert csr.memory_bytes() < dense.memory_bytes() or dense.cap * 12 == len(V)


def test_refusals_and_the_build_kind(corpus):
    V, Q = corpus
    with pytest.raises(ValueError, match="euclidean"):
        pr.IVFIndex(V, metric="cosine", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        pr.IVFIndex(V, layout="ragged", device="cpu")
    with pytest.raises(ValueError, match="exceeds corpus"):
        pr.IVFIndex(V[:5], n_cells=6, device="cpu")
    ix = pr.build_index(V, "ivf", device="cpu", **IVF_KW)
    assert isinstance(ix, pr.IVFIndex) and ix.n_cells == 12
    with pytest.raises(ValueError, match="exceeds the"):
        ix.search(Q, ix.max_k + 1)


def test_served_behind_an_endpoint(corpus, tmp_path):
    V, Q = corpus
    ix = pr.IVFIndex(V, **IVF_KW, int8=True, layout="csr", device="cpu")
    ep = IndexEndpoint("ivf", ix, k_max=32, warmup_queries=16, batch_limit=4).warmup()
    try:
        for rows, k in ((1, 1), (3, 10), (8, 32)):
            idx, dist = ep.query(Q[:rows], k)
            want = ix.search(Q[:rows], k)
            assert np.array_equal(idx, want[0]) and np.array_equal(dist, want[1])
        assert ep.stats()["index"]["kind"] == "ivf"
    finally:
        ep.shutdown()


# ------------------------------------------------- the JAX package's recall
def jax_reference_recall(n=1_000_000, d=64, queries=1024):
    """recall@10 of the JAX package's IVFIndex(V) and IVFIndex(V,
    int8=True) at chip_smoke.py's retrieval configuration (bench.py
    bench_retrieval's 1M x 64 corpus, 1024 queries), on the CPU.

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ivf.py
    """
    import json

    V, Q = jr.synthetic_corpus(n, d, n_clusters=max(16, n // 200), seed=0,
                               queries=queries)

    def search_all(ix):
        return np.concatenate([ix.search(Q[lo:lo + 64], 10)[0]
                               for lo in range(0, len(Q), 64)])

    want = search_all(jr.BruteForceIndex(V))
    out = {}
    for name, make in (("ivf", lambda: jr.IVFIndex(V)),
                       ("ivf_int8", lambda: jr.IVFIndex(V, int8=True))):
        t0 = time.perf_counter()
        ix = make()
        got = search_all(ix)
        out[name] = {"recall_at_10": float(np.mean(
            [len(np.intersect1d(g, w)) / 10.0 for g, w in zip(got, want)])),
            "build_and_search_s": time.perf_counter() - t0,
            "cap": ix.cap, "n_cells": ix.n_cells}
        print(f"jax_reference {name} " + json.dumps(out[name]), flush=True)
    return out


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax_reference_recall()
