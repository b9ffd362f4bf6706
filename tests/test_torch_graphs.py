"""The port's graph embeddings against the JAX package's, on the CPU.

- Walks are numpy draws: ``RandomWalkIterator`` (unweighted and weighted)
  and ``Node2VecWalkIterator`` (p, q; unweighted and weighted) give the
  JAX package's walks for the same graph and seed, bitwise, disconnected
  vertices self-looping.
- ``DeepWalk.fit`` and ``Node2Vec.fit`` on the host path (fewer than
  50,000 walk tokens, fewer pairs a chunk than a device-drawn batch
  macro): the same pairs and negatives (numpy), so the tables within
  atol 1e-5 and the loss history within rtol 1e-5 of the JAX fit's
  (torch and XLA sum the same products in other orders), and the same
  lookups (``similarity``, ``verts_nearest``).
"""

import numpy as np
import pytest

from deeplearning4j_tpu import graphs as jg

from deeplearning4j_tpu_torch import graphs as pg


def _graph(pkg, n=40, edges=120, seed=0, weighted=False, lonely=True):
    """The same random multigraph in ``pkg`` (one vertex left without
    edges when ``lonely``)."""
    rng = np.random.default_rng(seed)
    g = pkg.Graph(n)
    top = n - 1 if lonely else n
    for _ in range(edges):
        a, b = (int(v) for v in rng.integers(0, top, 2))
        g.add_edge(a, b, weight=float(rng.uniform(0.1, 2.0)) if weighted else 1.0)
    return g


@pytest.mark.parametrize("weighted", [False, True])
def test_walks_bitwise(weighted):
    jgr, pgr = _graph(jg, weighted=weighted), _graph(pg, weighted=weighted)
    for epoch in (0, 3):
        want = jg.RandomWalkIterator(jgr, 12, seed=5, weighted=weighted).walks(epoch)
        got = pg.RandomWalkIterator(pgr, 12, seed=5, weighted=weighted).walks(epoch)
        assert got == want
        assert [39] * 12 in got                            # the lone vertex
    for p, q in ((1.0, 0.5), (0.25, 4.0)):
        want = jg.node2vec.Node2VecWalkIterator(jgr, 12, p=p, q=q, seed=5,
                                                weighted=weighted).walks(1)
        got = pg.node2vec.Node2VecWalkIterator(pgr, 12, p=p, q=q, seed=5,
                                               weighted=weighted).walks(1)
        assert got == want


KW = dict(vector_size=16, window_size=3, walk_length=10, walks_per_vertex=2,
          batch_size=512, learning_rate=0.1, seed=11)


@pytest.mark.parametrize("kind", ["deepwalk", "node2vec"])
def test_host_path_fit_matches_jax(kind):
    jgr, pgr = _graph(jg, lonely=False), _graph(pg, lonely=False)
    if kind == "deepwalk":
        jm = jg.DeepWalk(**KW).fit(jgr)
        pm = pg.DeepWalk(device="cpu", **KW).fit(pgr)
    else:
        jm = jg.Node2Vec(p=1.0, q=0.5, **KW).fit(jgr)
        pm = pg.Node2Vec(p=1.0, q=0.5, device="cpu", **KW).fit(pgr)
    jv, pv = jm._vectors, pm._vectors
    assert pv.counters["batches"] > 2 and pv.counters.get("corpus_batches", 0) == 0
    assert pv.vocab.total_word_occurrences == 40 * KW["walks_per_vertex"] * KW["walk_length"]
    np.testing.assert_allclose(pv.syn0.numpy(), np.asarray(jv.syn0), atol=1e-5)
    np.testing.assert_allclose(pv.syn1.numpy(), np.asarray(jv.syn1), atol=1e-5)
    np.testing.assert_allclose(pv.loss_history, jv.loss_history, rtol=1e-5)
    assert jv._rng.bit_generator.state == pv._rng.bit_generator.state
    assert pm.num_vertices == jm.num_vertices == 40
    np.testing.assert_allclose(pm.get_vertex_vector(3), jm.get_vertex_vector(3), atol=1e-5)
    assert pm.similarity(1, 2) == pytest.approx(jm.similarity(1, 2), abs=1e-5)
    assert set(pm.verts_nearest(5, 3)) <= set(range(40))
    with pytest.raises(ValueError):
        pm.get_vertex_vector(1000)
