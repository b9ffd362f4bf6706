"""The port's leaf modules against the JAX package's, on the CPU: host code
the port keeps its own copy of, so every answer is compared exactly.

- CJK tokenizers: the same tokens for Chinese (dictionary forward maximum
  match, custom lexicon), Japanese (script runs, particles) and Korean
  (josa stripping, ``emit_josa=False``) text.
- ``BagOfWordsVectorizer`` / ``TfidfVectorizer``: the same vocabulary,
  vectors, idf and labelled ``DataSet``s, stop words and re-fit.
- ``CnnSentenceDataSetIterator``: the same (b, T, vec, 1) batches,
  per-step feature masks and one-hot labels, with both unknown-word
  policies; fed by the port's ``Word2Vec`` it lays out that model's
  vectors.
- ``Viterbi``: the same likelihood and smoothed labels.
- ``KDTree`` / ``VPTree``: the same ids and distances as the JAX package's
  trees and as a brute force ordered by (distance, index).
- ``NearestNeighborsServer``: the same JSON bodies and statuses for
  ``/status``, ``/knn``, ``/knnnew`` (JSON, base64 and batched) and the
  error routes.
- ``GlobalPoolingLayer`` over a masked time series (the pooling a
  sentence network's features mask reaches) within 1e-6 of the JAX
  layer's, masked steps left out.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import clustering as jcl
from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.utils.viterbi import Viterbi as JaxViterbi

from deeplearning4j_tpu_torch import clustering as pcl
from deeplearning4j_tpu_torch import nlp as pnlp
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

CJK_TEXTS = {
    "Chinese": ["我们喜欢机器学习", "犇犇", "我们用GPU训练", "中国人民银行在北京"],
    "Japanese": ["私はコーヒーを飲む", "データベースとネットワーク", "東京へ行きました"],
    "Korean": ["학교에서 공부를 한다", "물을", "서울에서 친구와 만났다"],
}


@pytest.mark.parametrize("lang", sorted(CJK_TEXTS))
def test_cjk_tokens(lang):
    name = f"{lang}TokenizerFactory"
    variants = [{}]
    if lang == "Chinese":
        variants.append({"lexicon": ["犇犇"]})
    if lang == "Korean":
        variants.append({"emit_josa": False})
    for kw in variants:
        j, p = getattr(jnlp, name)(**kw), getattr(pnlp, name)(**kw)
        for text in CJK_TEXTS[lang]:
            assert p.create(text).get_tokens() == j.create(text).get_tokens()


DOCS = ["the cat sat on the mat", "the dog ate my homework",
        "a cat and a dog are friends", "homework is due on monday",
        "the mat is red"]


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers(cls):
    labelled = [jnlp.LabelledDocument(d, [f"l{i % 2}"]) for i, d in enumerate(DOCS)]
    plabelled = [pnlp.LabelledDocument(d, [f"l{i % 2}"]) for i, d in enumerate(DOCS)]
    for kw in ({}, {"min_word_frequency": 2}, {"stop_words": ["the", "a"]}):
        j, p = getattr(jnlp, cls)(**kw), getattr(pnlp, cls)(**kw)
        jx, px = j.fit_transform(labelled), p.fit_transform(plabelled)
        assert px.dtype == jx.dtype and px.tobytes() == jx.tobytes()
        assert p.labels == j.labels and p.vocab_size() == j.vocab_size()
        assert [p.vocab.word_at_index(i) for i in range(p.vocab_size())] == \
            [j.vocab.word_at_index(i) for i in range(j.vocab_size())]
        jd, pd = j.vectorize("the cat ate the homework", "l1"), \
            p.vectorize("the cat ate the homework", "l1")
        assert np.array_equal(pd.features, jd.features)
        assert np.array_equal(pd.labels, jd.labels)
        if cls == "TfidfVectorizer":
            assert p.idf("cat") == j.idf("cat") and p.idf("zebra") == j.idf("zebra") == 0.0
    j, p = getattr(jnlp, cls)(), getattr(pnlp, cls)()
    j.fit(DOCS), p.fit(DOCS)
    j.fit(DOCS[:2]), p.fit(DOCS[:2])                       # re-fit replaces
    assert p.total_docs == j.total_docs == 2
    assert p.transform("cat dog").tobytes() == j.transform("cat dog").tobytes()


class _Vectors:
    """Word vectors from a fixed table: anything with ``word_vector``."""

    def __init__(self, words, dim=6, seed=0):
        rng = np.random.default_rng(seed)
        self.table = {w: rng.standard_normal(dim).astype(np.float32) for w in words}

    def word_vector(self, word):
        return self.table.get(word)


SENTS = ["the movie was great fun", "a dull and tedious plot", "great acting",
         "the plot was tedious and the acting dull and long", "fun UNK fun",
         "unseen words only"]
LABELS = ["pos", "neg", "pos", "neg", "pos", "neg"]


@pytest.mark.parametrize("unknown", ["remove_word", "use_unknown"])
def test_cnn_sentence_batches_and_masks(unknown):
    vocab = sorted({w for s in SENTS for w in s.split()} - {"unseen", "words", "only"})
    vectors = _Vectors(vocab)
    kw = dict(batch_size=4, max_sentence_length=7, unknown_word_handling=unknown)
    j = jnlp.CnnSentenceDataSetIterator(
        jnlp.CollectionLabeledSentenceProvider(SENTS, LABELS, seed=3), vectors, **kw)
    p = pnlp.CnnSentenceDataSetIterator(
        pnlp.CollectionLabeledSentenceProvider(SENTS, LABELS, seed=3), vectors, **kw)
    got, want = list(p), list(j)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.features.shape[2:] == (6, 1) and g.features.shape[1] <= 7
        for a, b in ((g.features, w.features), (g.features_mask, w.features_mask),
                     (g.labels, w.labels)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert p.get_labels() == j.get_labels() == ["neg", "pos"]
    assert p.load_single_sentence("great fun").tobytes() == \
        j.load_single_sentence("great fun").tobytes()
    # the port's own Word2Vec as the vector source
    w2v = pnlp.Word2Vec(layer_size=8, window_size=2, epochs=1, batch_size=64, seed=1,
                        device="cpu").fit(SENTS)
    it = pnlp.CnnSentenceDataSetIterator(
        pnlp.CollectionLabeledSentenceProvider(SENTS, LABELS), w2v, **kw)
    ds = it.next()
    assert ds.features.shape == (4, 7, 8, 1) and it.input_columns() == 8
    np.testing.assert_array_equal(ds.features[0, :5, :, 0], np.stack(
        [w2v.word_vector(t) for t in SENTS[0].split()]))
    assert ds.features_mask[0].tolist() == [1.0] * 5 + [0.0] * 2


def test_viterbi():
    rng = np.random.default_rng(0)
    truth = np.repeat(rng.integers(0, 3, 12), 5)
    noisy = np.where(rng.random(truth.size) < 0.2, rng.integers(0, 3, truth.size), truth)
    onehot = np.eye(3)[noisy]
    for kw in ({}, {"meta_stability": 0.6, "p_correct": 0.8}):
        j, p = JaxViterbi([10, 20, 30], **kw), Viterbi([10, 20, 30], **kw)
        for labels, binary in ((onehot, True), (noisy, False)):
            jl, jpath = j.decode(labels, binary)
            pl, ppath = p.decode(labels, binary)
            assert pl == jl and np.array_equal(ppath, jpath)
    with pytest.raises(ValueError):
        Viterbi([1])


def _brute(items, q, k):
    d = np.linalg.norm(items - q, axis=1)
    order = np.lexsort((np.arange(len(d)), d))[:k]
    return order, d[order]


@pytest.mark.parametrize("tree", ["KDTree", "VPTree"])
def test_trees_ids_and_distances(tree):
    rng = np.random.default_rng(3)
    items = rng.standard_normal((300, 5))
    items[7] = items[8]                                    # a tie
    j, p = getattr(jcl, tree)(items), getattr(pcl, tree)(items)
    for q in list(rng.standard_normal((8, 5))) + [items[8]]:
        pi, pd = p.search(q, 6)
        ji, jd = j.search(q, 6)
        assert list(pi) == list(ji) and np.array_equal(pd, jd)
        bi, bd = _brute(items, q, 6)
        np.testing.assert_allclose(pd, bd, rtol=1e-12)
        assert sorted(pi) == sorted(bi)
    if tree == "VPTree":
        pc = pcl.VPTree(items, distance="cosine").search(items[3], 4)
        jc = jcl.VPTree(items, distance="cosine").search(items[3], 4)
        assert list(pc[0]) == list(jc[0]) and np.array_equal(pc[1], jc[1])


def _post(port, path, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_nearest_neighbors_server_responses():
    from deeplearning4j_tpu_torch.serving.wire import encode_array
    rng = np.random.default_rng(5)
    points = rng.standard_normal((60, 4))
    labels = [f"p{i}" for i in range(60)]
    q = rng.standard_normal((3, 4)).astype(np.float32)
    requests = [
        ("GET", "/status", None), ("GET", "/nope", None),
        ("POST", "/knn", {"index": 4, "k": 3}),
        ("POST", "/knn", {"index": 99, "k": 3}),
        ("POST", "/knnnew", {"vector": q[0].tolist(), "k": 5}),
        ("POST", "/knnnew", {"ndarray": q.tolist(), "k": 2}),
        ("POST", "/knnnew", {**encode_array(q, "x_b64"), "k": 2, "b64": True}),
        ("POST", "/knnnew", {**encode_array(q[0], "x_b64"), "k": 3}),
        ("POST", "/knnnew", {"vector": [1.0, 2.0], "k": 1}),
        ("POST", "/knnnew", {"vector": q[0].tolist(), "k": 0}),
        ("POST", "/knnnew", b"[1, 2]"), ("POST", "/knnnew", b"{not json"),
        ("POST", "/other", {"k": 1}),
    ]
    answers = {}
    for name, mod in (("jax", jcl), ("port", pcl)):
        srv = mod.NearestNeighborsServer(points, labels=labels).start(port=0)
        try:
            answers[name] = [_get(srv.port, path) if method == "GET"
                             else _post(srv.port, path, body)
                             for method, path, body in requests]
        finally:
            srv.stop()
    assert answers["port"] == answers["jax"]
    codes = [code for code, _ in answers["port"]]
    assert codes == [200, 404, 200, 400, 200, 200, 200, 200, 400, 400, 400, 400, 404]
    knn = answers["port"][2][1]["results"]
    assert [r["index"] for r in knn] == list(_brute(points, points[4], 4)[0][1:])


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_leaves_masked_steps_out(pooling):
    """A (batch, time) features mask on a time series: the masked steps
    take no part in the pooled vector, as in the JAX package's layer."""
    import jax.numpy as jnp
    import torch

    from deeplearning4j_tpu.nn.conf.pooling import GlobalPoolingLayer as JaxPool

    from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    mask = (np.arange(7)[None, :] < np.array([[7], [4], [1]])).astype(np.float32)
    got, _ = GlobalPoolingLayer(pooling_type=pooling).apply(
        {}, {}, torch.tensor(x), mask=torch.tensor(mask))
    want, _ = JaxPool(pooling_type=pooling).apply({}, {}, jnp.asarray(x),
                                                  mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if pooling == "max":
        np.testing.assert_array_equal(got.numpy()[2], x[2, 0])
