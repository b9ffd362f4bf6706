"""The PyTorch port's retrieval slice against the JAX package, on the CPU.

Indexes built by the JAX package cross to the port as the ``.npz`` their
``save()`` writes (``interop.index_from_jax``) and answer the same queries;
the port's own ``save()`` loads back into the JAX package. The port's
K-Means, PQ codec and index builds are checked against JAX's on seeded
corpora, and ``IndexEndpoint`` is driven through its serving contract.
Inputs come from numpy with fixed seeds; the JAX side runs its Pallas ADC
and int4 kernels in interpret mode.

Tolerances: ids equal; distances within rtol 1e-5 (LUTs, norms and dots are
products that torch and XLA round differently on the CPU). K-Means
centroids and PQ codebooks within 1e-4 absolute on a well-separated corpus
(the same seeded draws, then float32 Lloyd steps summed in another order).
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import retrieval as jr
from deeplearning4j_tpu.clustering.kmeans import KMeansClustering as JaxKMeans
from deeplearning4j_tpu.perf import pallas as pk

from deeplearning4j_tpu_torch import retrieval as pr
from deeplearning4j_tpu_torch.clustering import KMeansClustering
from deeplearning4j_tpu_torch.interop import index_from_jax
from deeplearning4j_tpu_torch.parallel import DeadlineExpiredError, QueueFullError
from deeplearning4j_tpu_torch.serving import BreakerOpenError, CircuitBreaker

RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    return pr.synthetic_corpus(1500, 16, n_clusters=15, seed=0, queries=24)


def _jax_search(ix, q, k):
    with pk.override(enabled=True):
        return ix.search(q, k)


def _same_answers(a, b):
    (ia, da), (ib, db) = a, b
    assert np.array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=RTOL)


JAX_VARIANTS = {
    "pq": lambda V: jr.PQIndex(V, M=4, ksub=32, seed=3, rerank=4),
    "ivf_pq": lambda V: jr.IVFPQIndex(V, M=4, ksub=32, seed=3, n_cells=8,
                                      nprobe=3),
    "brute": lambda V: jr.BruteForceIndex(V),
    "brute_int8": lambda V: jr.BruteForceIndex(V, int8=True),
    "brute_int4": lambda V: jr.BruteForceIndex(V, int4=True),
}


@pytest.mark.parametrize("variant", sorted(JAX_VARIANTS))
def test_jax_index_crosses_both_ways(variant, corpus, tmp_path):
    V, Q = corpus
    jix = JAX_VARIANTS[variant](V)
    want = _jax_search(jix, Q, 10)
    pix = index_from_jax(jix.save(str(tmp_path / "jax.npz")), device="cpu")
    assert (pix.kind, pix.codec, pix.rerank) == (jix.kind, jix.codec, jix.rerank)
    assert pix.memory_bytes() == jix.memory_bytes()
    _same_answers(pix.search(Q, 10), want)
    back = jr.load_index(pix.save(str(tmp_path / "port.npz")))
    _same_answers(_jax_search(back, Q, 10), want)


def test_port_builds_match_jax_builds(corpus):
    """The same seeded build in both packages: same sample, same k-means++
    seeds, same codes; the answers agree."""
    V, Q = corpus
    for jcls, pcls, kw in ((jr.PQIndex, pr.PQIndex, dict(M=4, ksub=32, seed=3)),
                           (jr.IVFPQIndex, pr.IVFPQIndex,
                            dict(M=4, ksub=32, seed=3, n_cells=8, nprobe=3))):
        jix, pix = jcls(V, **kw), pcls(V, device="cpu", **kw)
        np.testing.assert_allclose(pix.pq.codebooks, np.asarray(jix.pq.codebooks),
                                   atol=1e-4)
        codes = "_codes" if pcls is pr.PQIndex else "_flat_codes"
        assert np.array_equal(getattr(pix, codes).numpy(),
                              np.asarray(getattr(jix, codes)))
        _same_answers(pix.search(Q, 10), _jax_search(jix, Q, 10))


def test_kmeans_and_pq_codec_match_jax():
    rng = np.random.default_rng(1)
    means = rng.standard_normal((6, 8)).astype(np.float32) * 6.0
    x = (means[rng.integers(0, 6, 600)]
         + rng.standard_normal((600, 8)).astype(np.float32) * 0.3)
    jk = JaxKMeans(6, max_iterations=30, seed=5)
    ja, jc = jk.apply_to(x, check_every=4)
    pk_ = KMeansClustering(6, max_iterations=30, seed=5, device="cpu")
    pa, pc = pk_.apply_to(x, check_every=4)
    assert np.array_equal(pa, np.asarray(ja))
    np.testing.assert_allclose(pc, np.asarray(jc), atol=1e-4)
    assert pk_.iterations_run == jk.iterations_run
    np.testing.assert_allclose(pk_.cost, jk.cost, rtol=1e-4)

    jcodec = jr.PQCodec(4, ksub=16, seed=2).train(x)
    pcodec = pr.PQCodec(4, ksub=16, seed=2, device="cpu").train(x)
    np.testing.assert_allclose(pcodec.codebooks, np.asarray(jcodec.codebooks),
                               atol=1e-4)
    assert np.array_equal(pcodec.encode(x), np.asarray(jcodec.encode(x)))
    np.testing.assert_allclose(pcodec.distortion(x, pcodec.encode(x)),
                               jcodec.distortion(x, jcodec.encode(x)), rtol=1e-4)


def test_pq_recall_gate_and_compression(corpus):
    V, Q = corpus
    exact = pr.BruteForceIndex(V, device="cpu")
    pq = pr.PQIndex(V, M=4, ksub=64, rerank=16, seed=3, device="cpu")
    report = pr.assert_recall_within(pq, Q, 10, baseline=exact, max_delta=0.05,
                                     exact=exact)
    assert report["recall"] >= 0.95
    assert V.nbytes / pq.memory_bytes() >= 8
    with pytest.raises(pr.RecallGateError):
        pr.assert_recall_within(pr.PQIndex(V, M=2, ksub=4, seed=3, device="cpu"),
                                Q, 10, min_recall=0.99, exact=exact)
    with pytest.raises(ValueError, match="exact reference"):
        pr.recall_at_k(pq, Q, 10)


def test_streaming_build_equals_materialized(corpus):
    V, Q = corpus
    passes = []

    def factory():
        passes.append(1)
        for lo in range(0, len(V), 400):
            yield V[lo:lo + 400]

    for kind, cls, kw in (("pq", pr.PQIndex, {}),
                          ("ivf_pq", pr.IVFPQIndex, dict(n_cells=8))):
        s = pr.build_index_streaming(factory, kind=kind, M=4, ksub=32, seed=3,
                                     train_size=len(V), device="cpu", **kw)
        m = cls(V, M=4, ksub=32, seed=3, train_size=len(V), device="cpu", **kw)
        i1, d1 = s.search(Q, 7)
        i2, d2 = m.search(Q, 7)
        assert np.array_equal(i1, i2) and np.array_equal(d1, d2)
        if kind == "pq":
            m_pq = m
    assert sum(passes) == 4                     # two passes per build
    for source in ([V[:700], V[700:]], V):      # a re-iterable, an array
        s = pr.build_index_streaming(source, kind="pq", M=4, ksub=32, seed=3,
                                     train_size=len(V), device="cpu")
        assert np.array_equal(s.search(Q, 7)[0], m_pq.search(Q, 7)[0])
    with pytest.raises(ValueError, match="RE-STARTABLE"):
        pr.build_index_streaming(factory(), kind="pq", M=4, ksub=32,
                                 device="cpu")
    with pytest.raises(ValueError):
        pr.build_index_streaming(V, kind="brute", device="cpu")


def test_build_index_from_network_and_kinds(corpus):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration, InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    V, Q = corpus
    ix = pr.build_index(net, "brute", inputs=V[:300], device="cpu")
    assert (ix.size, ix.dim) == (300, 8)
    emb = net.feed_forward(V[:5])[-2].numpy()
    idx, dist = ix.search(emb, 1)
    assert np.array_equal(idx[:, 0], np.arange(5)) and np.allclose(dist, 0, atol=1e-3)
    ivf = pr.build_index(V, "ivf", device="cpu", n_cells=8, nprobe=3)
    assert isinstance(ivf, pr.IVFIndex) and ivf.search(V[:4], 1)[0][:, 0].tolist() == [0, 1, 2, 3]


def test_ivf_file_and_no_device_raise(corpus, tmp_path):
    V, Q = corpus
    jix = jr.IVFIndex(V[:400], n_cells=4)
    ix = pr.load_index(jix.save(str(tmp_path / "ivf.npz")), device="cpu")
    assert isinstance(ix, pr.IVFIndex)
    assert np.array_equal(ix.search(Q[:8], 5)[0], jix.search(Q[:8], 5)[0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    for make in (lambda: pr.BruteForceIndex(V), lambda: pr.PQIndex(V, M=4),
                 lambda: pr.IVFIndex(V, n_cells=4),
                 lambda: KMeansClustering(4),
                 lambda: pr.load_index(jr.BruteForceIndex(V[:50]).save(
                     str(tmp_path / "b.npz")))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ------------------------------------------------------------- endpoint
class _GatedIndex:
    """Wraps an index: dispatches block on ``gate`` (set by default) and
    can be told to fail, so the tests control capacity and faults."""

    def __init__(self, inner):
        self.inner = inner
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.fail_next = 0
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def search(self, q, k):
        self.calls.append((len(q), k))
        self.entered.set()
        assert self.gate.wait(timeout=30)
        if self.fail_next:
            self.fail_next -= 1
            raise RuntimeError("injected dispatch fault")
        return self.inner.search(q, k)


def test_endpoint_coalesces_mixed_k_and_answers_each(corpus):
    V, Q = corpus
    ix = _GatedIndex(pr.PQIndex(V, M=4, ksub=32, seed=3, device="cpu"))
    ep = pr.IndexEndpoint("pq", ix, k_default=5, k_max=16, warmup_queries=32,
                          queue_timeout_ms=50.0)
    try:
        ep.warmup()
        ix.gate.clear()
        blocker = ep.submit(Q[:1], 3)
        assert ix.entered.wait(timeout=10)
        reqs = [(Q[i:i + 1 + i % 3], k) for i, k in zip(range(6), (1, 10, 4, 16, 10, 2))]
        obs = [ep.submit(q, k) for q, k in reqs]
        ix.gate.set()
        blocker.get(timeout=30)
        got = [o.get(timeout=30) for o in obs]
        assert ix.calls[-1] == (sum(len(q) for q, _ in reqs), 16)  # one dispatch
        for (q, k), (idx, dist) in zip(reqs, got):
            want_i, want_d = ix.inner.search(q, k)
            assert idx.shape == (len(q), k)
            assert np.array_equal(idx, want_i) and np.allclose(dist, want_d)
        st = ep.stats()
        assert st["queries_served"] == 7 and st["batches_dispatched"] == 2
        assert st["index"]["codec"] == "pq" and "compile_watch" not in st["index"]
    finally:
        ep.shutdown()


def test_endpoint_queue_full_deadline_and_breaker(corpus):
    V, Q = corpus
    ix = _GatedIndex(pr.BruteForceIndex(V[:300], device="cpu"))
    ep = pr.IndexEndpoint("b", ix, k_default=3, queue_depth=2, batch_limit=1,
                          warmup_queries=8,
                          breaker=CircuitBreaker(failure_threshold=2, window_s=10.0,
                                                 cooldown_s=30.0))
    try:
        ix.gate.clear()
        first = ep.submit(Q[:1], 3)
        assert ix.entered.wait(timeout=10)
        short = ep.submit(Q[:1], 3, deadline=time.monotonic() + 0.05)
        ep.submit(Q[:1], 3)
        with pytest.raises(QueueFullError):
            ep.submit(Q[:1], 3)
        time.sleep(0.15)                        # the short deadline passes
        ix.gate.set()
        first.get(timeout=30)
        with pytest.raises(DeadlineExpiredError, match="before batch dispatch"):
            short.get(timeout=30)
        st = ep.stats()["queue"]
        assert st["rejected"] == 1 and st["expired"] == 1
        with pytest.raises(ValueError):
            ep.query(np.zeros((2, 3), np.float32), 3)   # caller error
        assert ep.breaker.state == "closed"
        ix.fail_next = 2
        for _ in range(2):
            with pytest.raises(pr.IndexDispatchError):
                ep.query(Q[:1], 3)
        with pytest.raises(BreakerOpenError):
            ep.query(Q[:1], 3)
    finally:
        ep.shutdown()


def test_swap_index_under_load_drops_nothing(corpus):
    V, Q = corpus
    ep = pr.IndexEndpoint("live", pr.BruteForceIndex(V, device="cpu"),
                          k_default=5, k_max=8, warmup_queries=16,
                          default_deadline_ms=20_000.0)
    ep.warmup()
    stop = threading.Event()
    results, errors = [], []

    def client(cid):
        while not stop.is_set():
            try:
                idx, _ = ep.query(Q[cid:cid + 1 + cid % 3], 5)
                results.append(idx.shape)
            except Exception as e:  # every admitted request must answer
                errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        ep.swap_index(pr.PQIndex(V, M=4, ksub=32, rerank=4, seed=3, device="cpu"))
        time.sleep(0.2)
        ep.swap_index(pr.BruteForceIndex(V, int4=True, rerank=2, device="cpu"))
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        ep.shutdown()
    assert not errors, errors[:3]
    assert len(results) >= 20 and all(s[1] == 5 for s in results)
    assert ep.stats()["swaps"] == 2 and ep.index.codec == "int4"


# ------------------------------------------------- the JAX package's recall
def jax_reference_recall(n=1_000_000, d=64, queries=1024):
    """recall@10 of the JAX package's PQ and IVF-PQ indexes at
    chip_smoke.py's retrieval configuration (the JAX package's full
    retrieval benchmark), on the CPU: the reference for the card's recall
    gates.

        JAX_PLATFORMS=cpu python tests/test_torch_retrieval.py
    """
    import json

    V, Q = jr.synthetic_corpus(n, d, n_clusters=max(16, n // 200), seed=0,
                               queries=queries)

    def search_all(ix):
        return np.concatenate([ix.search(Q[lo:lo + 256], 10)[0]
                               for lo in range(0, len(Q), 256)])

    want = search_all(jr.BruteForceIndex(V))
    out = {}
    for name, make in (("pq", lambda: jr.PQIndex(V, M=8, ksub=256, rerank=16)),
                       ("ivf_pq", lambda: jr.IVFPQIndex(V, M=8, ksub=256,
                                                        rerank=8)),
                       ("int4", lambda: jr.BruteForceIndex(V, int4=True))):
        t0 = time.perf_counter()
        ix = make()
        got = search_all(ix)
        out[name] = {"recall_at_10": float(np.mean(
            [len(np.intersect1d(g, w)) / 10.0 for g, w in zip(got, want)])),
            "build_and_search_s": time.perf_counter() - t0}
        print(f"jax_reference {name} " + json.dumps(out[name]), flush=True)
    return out


if __name__ == "__main__":
    jax_reference_recall()
