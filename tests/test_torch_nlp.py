"""The NLP slice of the PyTorch port against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX package's
functions (XLA on the CPU, where its scatter is ``.at[].add``) and the
port's (plain tensor code; the ``scatter_add`` wrapper takes its plain
version on a CPU tensor). Tolerances, with their reasons:

- vocabulary, Huffman codes / points / lengths, the unigram table, the
  tokenizers and the host pair / bag generation are integer or string
  work, equal outright, as is ``_scatter_mean_update`` (the same float32
  operations in the same order, and the ordered scatter), bitwise;
- a step function adds its dot products in torch's einsum order, not
  XLA's: one step agrees within rtol 1e-5 / atol 1e-6 of float32 tables of
  magnitude ~1 (measured: at most 1e-7, a few ulps);
- a whole host-path fit from the same seed sees the same pairs and
  negatives; the per-step rounding differences compound over its batches:
  tables within atol 1e-5, the epoch loss within rtol 1e-5;
- the corpus-resident path draws with Philox, not threefry, so its step is
  held on given draws against a jnp transcription of the JAX step, and its
  draws by their distribution;
- quality on the two-topic corpus: the margins tests/test_nlp.py asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import kernels as jk
from deeplearning4j_tpu.nlp import vocab as jvocab

from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import nlp as pnlp
from deeplearning4j_tpu_torch import retrieval
from deeplearning4j_tpu_torch.nlp import kernels as pk
from deeplearning4j_tpu_torch.nlp import vocab as pvocab
from deeplearning4j_tpu_torch.perf.kernels import scatter_add as sa

RTOL, ATOL = 1e-5, 1e-6
W2V_KW = dict(layer_size=32, window_size=3, epochs=20, batch_size=512,
              learning_rate=0.3, min_word_frequency=1, seed=42)


def two_topic_corpus(n=300, seed=7):
    """tests/test_nlp.py's corpus: two disjoint topical vocabularies."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tools = ["hammer", "wrench", "drill", "saw", "pliers", "chisel"]
    sents = []
    for _ in range(n):
        pool = animals if rng.random() < 0.5 else tools
        words = rng.choice(pool, size=rng.integers(4, 9))
        sents.append(" ".join(words))
    return sents, animals, tools


def zipf_corpus(n_sent=300, sent_len=12, vocab_n=400, seed=0):
    """bench.py's Word2Vec corpus (Zipf over a synthetic vocab), small."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab_n + 1)
    words = np.array([f"w{i}" for i in range(vocab_n)])
    choice = rng.choice(vocab_n, (n_sent, sent_len), p=p / p.sum())
    return [" ".join(words[row]) for row in choice]


def intra_vs_inter(model, animals, tools):
    intra = np.mean([model.similarity(a, b) for a in animals for b in animals if a != b])
    inter = np.mean([model.similarity(a, t) for a in animals for t in tools])
    return intra, inter


def T(a):
    return torch.from_numpy(np.array(a))


def _close(jax_out, port_out, rtol=RTOL, atol=ATOL):
    for j, p in zip(jax_out, port_out):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=rtol, atol=atol)


# ------------------------------------------------------------ host-side parity
@pytest.mark.parametrize("corpus", ["two_topic", "zipf"])
def test_vocab_huffman_unigram_equal(corpus):
    sents = two_topic_corpus()[0] if corpus == "two_topic" else zipf_corpus()
    toks = [s.split() for s in sents]
    jc = jvocab.VocabConstructor(1).build_joint_vocabulary([toks])
    pc = pvocab.VocabConstructor(1).build_joint_vocabulary([toks])
    assert jc.words() == pc.words()
    assert [w.count for w in jc.vocab_words()] == [w.count for w in pc.vocab_words()]
    for a, b in zip(jvocab.build_huffman(jc), pvocab.build_huffman(pc)):
        np.testing.assert_array_equal(a, b)
    assert [w.points for w in jc.vocab_words()] == [w.points for w in pc.vocab_words()]
    np.testing.assert_array_equal(jvocab.unigram_table(jc), pvocab.unigram_table(pc))


def test_tokenizers_equal():
    from deeplearning4j_tpu.nlp import tokenization as jt
    from deeplearning4j_tpu_torch.nlp import tokenization as pt
    text = "Hello, World! 123 the (quick) brown fox; jumps?"
    for make in (lambda m: m.DefaultTokenizerFactory(),
                 lambda m: m.DefaultTokenizerFactory().set_token_pre_processor(
                     m.CommonPreprocessor()),
                 lambda m: m.NGramTokenizerFactory(min_n=1, max_n=3)):
        assert make(jt).create(text).get_tokens() == make(pt).create(text).get_tokens()


@pytest.mark.parametrize("sampling", [0.0, 1e-2])
def test_pairs_and_bags_equal_from_the_same_seed(sampling):
    sents = zipf_corpus(n_sent=80)
    kw = dict(layer_size=8, window_size=4, seed=3, sampling=sampling)
    jm = jnlp.Word2Vec(**kw)
    pm = pnlp.Word2Vec(device="cpu", **kw)
    for m in (jm, pm):
        m.build_vocab([s.split() for s in sents])
    jseqs = list(jm._index_sequences(s.split() for s in sents))
    pseqs = list(pm._index_sequences(s.split() for s in sents))
    for a, b in zip(jseqs, pseqs):
        np.testing.assert_array_equal(a, b)
    for fn in ("_pairs_for_chunk", "_bags_for_chunk", "_pairs_for_chunk"):
        for a, b in zip(getattr(jm, fn)(jseqs), getattr(pm, fn)(pseqs)):
            np.testing.assert_array_equal(a, b)
    assert jm._rng.bit_generator.state == pm._rng.bit_generator.state


# ------------------------------------------------------------- step parity
def _step_operands(seed=0, V=40, D=16, B=64, K=3, L=5, W=4):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        syn0=(rng.standard_normal((V, D)) * 0.3).astype(f32),
        syn1=(rng.standard_normal((V, D)) * 0.3).astype(f32),
        centers=rng.integers(0, V, B).astype(np.int32),
        contexts=rng.integers(0, V, B).astype(np.int32),
        negs=rng.integers(0, V, (B, K)).astype(np.int32),
        wmask=(rng.random(B) < 0.9).astype(f32),
        codes=rng.integers(0, 2, (B, L)).astype(np.int32),
        points=rng.integers(0, V, (B, L)).astype(np.int32),
        lengths=rng.integers(0, L + 1, B).astype(np.int32),
        bags=rng.integers(0, V, (B, 2 * W)).astype(np.int32),
        bag_mask=(rng.random((B, 2 * W)) < 0.7).astype(f32),
        docvec=rng.standard_normal(D).astype(f32),
        lr=np.float32(0.3))


def test_scatter_mean_update_bitwise():
    rng = np.random.default_rng(5)
    V, D, N = 30, 12, 400
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[rng.random((V, D)) < 0.1] = -0.0
    idx = rng.integers(0, V, N).astype(np.int32)
    grads = (rng.standard_normal((N, D)) * 10.0 ** rng.integers(-8, 8, (N, D))).astype(np.float32)
    w = (rng.random(N) < 0.8).astype(np.float32)
    lr = np.float32(0.0731)
    want = jax.jit(jk._scatter_mean_update)(table, idx, grads, w, lr)
    got = pk._scatter_mean_update(T(table), T(idx), T(grads), T(w), lr)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


STEPS = {
    "sgns": (jk.sgns_step, pk.sgns_step,
             ("syn0", "syn1", "centers", "contexts", "negs", "wmask", "lr")),
    "hs": (jk.hs_step, pk.hs_step,
           ("syn0", "syn1", "contexts", "codes", "points", "lengths", "lr")),
    "cbow": (jk.cbow_step, pk.cbow_step,
             ("syn0", "syn1", "centers", "bags", "bag_mask", "negs", "wmask", "lr")),
    "cbow_hs": (jk.cbow_hs_step, pk.cbow_hs_step,
                ("syn0", "syn1", "codes", "points", "lengths", "bags", "bag_mask", "lr")),
    "sgns_infer": (jk.sgns_infer_step, pk.sgns_infer_step,
                   ("docvec", "syn1", "centers", "negs", "wmask", "lr")),
    "cbow_infer": (jk.cbow_infer_step, pk.cbow_infer_step,
                   ("docvec", "syn0", "syn1", "centers", "bags", "bag_mask", "negs",
                    "wmask", "lr")),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_matches_jax(name):
    jfn, pfn, names = STEPS[name]
    ops = _step_operands()
    args = [ops[n] for n in names]
    want = jfn(*[a.copy() if isinstance(a, np.ndarray) else a for a in args])
    got = pfn(*[T(a) if isinstance(a, np.ndarray) else a for a in args])
    _close(want, got)


def test_glove_step_matches_jax():
    rng = np.random.default_rng(9)
    V, D, B = 25, 8, 64
    f32 = np.float32
    tabs = [(rng.standard_normal(s) * 0.2).astype(f32) for s in ((V, D), (V, D), (V,), (V,))]
    acc = [(rng.random(s) * 0.5).astype(f32) for s in ((V, D), (V, D), (V,), (V,))]
    rows = rng.integers(0, V, B).astype(np.int32)
    cols = rng.integers(0, V, B).astype(np.int32)
    logx = rng.random(B).astype(f32)
    weight = (rng.random(B) * (rng.random(B) < 0.9)).astype(f32)
    want = jk.glove_step(*[a.copy() for a in tabs + acc], rows, cols, logx, weight,
                         np.float32(0.05))
    got = pk.glove_step(*[T(a) for a in tabs + acc], T(rows), T(cols), T(logx),
                        T(weight), 0.05)
    _close(want, got)


def test_sgns_scan_matches_jax_and_the_step_loop():
    ops = _step_operands(seed=2)
    rng = np.random.default_rng(4)
    k, B, V = 3, 64, 40
    ce = rng.integers(0, V, (k, B)).astype(np.int32)
    ct = rng.integers(0, V, (k, B)).astype(np.int32)
    ng = rng.integers(0, V, (k, B, 3)).astype(np.int32)
    wm = np.ones((k, B), np.float32)
    want = jk.sgns_scan(ops["syn0"].copy(), ops["syn1"].copy(), ce, ct, ng, wm, ops["lr"])
    got = pk.sgns_scan(T(ops["syn0"]), T(ops["syn1"]), T(ce), T(ct), T(ng), T(wm), ops["lr"])
    _close(want, got)
    s0, s1 = T(ops["syn0"]), T(ops["syn1"])
    for i in range(k):
        s0, s1, _ = pk.sgns_step(s0, s1, T(ce[i]), T(ct[i]), T(ng[i]), T(wm[i]), ops["lr"])
    assert torch.equal(s0, got[0]) and torch.equal(s1, got[1])


# --------------------------------------------------------- corpus-resident
@jax.jit
def _jax_corpus_step(s0, s1, centers, contexts, negs, wmask, lr):
    """kernels.py:453-469 of the JAX package, line by line, on given draws,
    with its own _scatter_mean_update."""
    eps = 1e-7
    v = s0[contexts]
    u_pos = s1[centers]
    u_neg = s1[negs]
    s_pos = jax.nn.sigmoid(jnp.sum(v * u_pos, -1))
    s_neg = jax.nn.sigmoid(v @ u_neg.T)
    g_pos = (1.0 - s_pos) * wmask
    g_neg = -s_neg * wmask[:, None]
    dv = g_pos[:, None] * u_pos + g_neg @ u_neg
    du_pos = g_pos[:, None] * v
    s0 = jk._scatter_mean_update(s0, contexts, dv, wmask, lr)
    s1 = jk._scatter_mean_update(s1, centers, du_pos, wmask, lr)
    npairs = jnp.maximum(jnp.sum(wmask), 1.0)
    s1 = s1.at[negs].add(lr * (g_neg.T @ v) / npairs)
    nll = -(jnp.log(s_pos + eps) + jnp.sum(jnp.log(1.0 - s_neg + eps), -1))
    return s0, s1, jnp.sum(nll * wmask) / npairs


def test_corpus_step_matches_jax_on_given_draws():
    ops = _step_operands(seed=8, B=256)
    rng = np.random.default_rng(1)
    negs = rng.integers(0, 40, 5).astype(np.int32)
    negs[3] = negs[0]  # a repeated shared negative adds twice, in order
    args = (ops["centers"], ops["contexts"], negs, ops["wmask"])
    want = _jax_corpus_step(ops["syn0"], ops["syn1"], *args, ops["lr"])
    before = sa.launches
    got = pk.sgns_corpus_step(T(ops["syn0"]), T(ops["syn1"]), *map(T, args), ops["lr"])
    assert sa.launches == before  # CPU tensors: the plain version
    _close(want, got)


def test_corpus_draws_distribution():
    """Offsets d ∝ W - d + 1, sides balanced, no valid pair crossing a
    sentence or the true length, negatives from the unigram table. Word id
    = position, so centers and contexts are the drawn positions."""
    W, B, K = 5, 200_000, 5
    lens = np.random.default_rng(0).integers(3, 40, 300)
    T_true = int(lens.sum())
    sid = torch.from_numpy(np.repeat(np.arange(len(lens)), lens).astype(np.int32))
    corpus = torch.arange(T_true, dtype=torch.int32)
    neg_table = torch.from_numpy(np.repeat(np.arange(4), [10, 20, 30, 40]).astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    ce, ct, negs, wm = pk.corpus_draws(gen, corpus, sid, neg_table, pk.offset_cdf(W, "cpu"),
                                       B, K)
    assert ce.dtype == ct.dtype == negs.dtype == torch.int32 and negs.shape == (K,)
    ce, ct, valid = ce.long(), ct.long(), wm.bool()
    d = (ct - ce).abs()
    # interior positions are never clipped: their offsets and sides are exact
    inner = (ce >= W) & (ce < T_true - W)
    freq = torch.bincount(d[inner], minlength=W + 1)[1:].double() / inner.sum()
    want = torch.arange(W, 0, -1, dtype=torch.float64) / (W * (W + 1) / 2)
    assert torch.allclose(freq, want, atol=0.005), (freq, want)
    right = ((ct > ce) & inner).sum() / inner.sum()
    assert abs(float(right) - 0.5) < 0.005
    assert bool((sid[ce[valid]] == sid[ct[valid]]).all())
    assert bool(((d[valid] >= 1) & (d[valid] <= W)).all())
    assert bool((ct[valid] < T_true).all()) and bool((ct[valid] >= 0).all())
    # an invalid pair crossed a sentence, or ran off an end of the corpus
    # (only from within W of it; its context position was clipped)
    cross = sid[ce[~valid]] != sid[ct[~valid]]
    assert bool((cross | ~inner[~valid]).all())
    many = torch.cat([pk.corpus_draws(gen, corpus, sid, neg_table, pk.offset_cdf(W, "cpu"),
                                      1, 2000)[2] for _ in range(5)])
    share = torch.bincount(many, minlength=4).double() / many.numel()
    assert torch.allclose(share, torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64),
                          atol=0.02), share


def test_corpus_quota_and_counters():
    """T * (W + 1) pairs per segment: ceil(T * (W + 1) / B) batches, each of
    three scatter updates; segments hold whole sentences within the budget."""
    sents = zipf_corpus(n_sent=100, sent_len=10, vocab_n=50)
    m = pnlp.Word2Vec(layer_size=8, window_size=3, negative=2, epochs=2, batch_size=64,
                      device_corpus=True, device="cpu", seed=1)
    m._DEVICE_CORPUS_SEG_TOKENS = 256
    m.fit(sents)
    segs = list(m._corpus_segments(lambda: (s.split() for s in sents)))
    assert len(segs) == 4 and all(T <= 256 for _, _, T, _ in segs)
    assert sum(T for _, _, T, _ in segs) == 1000
    assert [nvb for *_, nvb in segs] == [-(-T * 4 // 64) for _, _, T, _ in segs]
    assert m.counters["corpus_segments"] == 2 * len(segs)
    assert m.counters["corpus_batches"] == 2 * sum(nvb for *_, nvb in segs)
    assert len(m.loss_history) == 2 and np.isfinite(m.loss_history).all()


# --------------------------------------------------------------- whole fit
@pytest.mark.parametrize("negative", [5, 0])
def test_host_path_fit_matches_jax(negative):
    """One epoch of skip-gram on the host path, same seed: the same pairs
    and negatives (numpy), fewer than batch_size * 8 pairs per chunk so no
    device-drawn macro runs."""
    sents, _, _ = two_topic_corpus(n=60)
    kw = dict(layer_size=16, window_size=3, negative=negative, epochs=1, batch_size=256,
              learning_rate=0.1, seed=11)
    jm = jnlp.Word2Vec(**kw).fit(sents)
    pm = pnlp.Word2Vec(device="cpu", **kw).fit(sents)
    assert pm.counters["batches"] > 2
    np.testing.assert_allclose(pm.syn0.numpy(), np.asarray(jm.syn0), atol=1e-5)
    np.testing.assert_allclose(pm.syn1.numpy(), np.asarray(jm.syn1), atol=1e-5)
    np.testing.assert_allclose(pm.loss_history, jm.loss_history, rtol=1e-5)
    assert jm._rng.bit_generator.state == pm._rng.bit_generator.state


# ----------------------------------------------------------------- quality
@pytest.mark.parametrize("negative,use_cbow,lr,epochs", [
    (5, False, 0.3, 20), (0, False, 0.3, 20), (5, True, 1.0, 40), (0, True, 0.3, 20)])
def test_word2vec_topics(negative, use_cbow, lr, epochs):
    sents, animals, tools = two_topic_corpus(n=200)
    model = pnlp.Word2Vec(negative=negative, use_cbow=use_cbow, device="cpu",
                          **dict(W2V_KW, learning_rate=lr, epochs=epochs)).fit(sents)
    assert model.vocab_size() == 12
    intra, inter = intra_vs_inter(model, animals, tools)
    assert intra > inter + 0.3, f"intra={intra:.3f} inter={inter:.3f}"


def test_corpus_path_quality():
    sents, animals, tools = two_topic_corpus()
    model = pnlp.Word2Vec(device_corpus=True, device="cpu", **W2V_KW).fit(sents)
    intra, inter = intra_vs_inter(model, animals, tools)
    assert intra > inter + 0.25, f"intra={intra:.3f} inter={inter:.3f}"
    assert len(model.loss_history) == model.epochs
    assert model.loss_history[-1] < model.loss_history[0]
    assert model.counters["corpus_batches"] > 0 and model.counters["batches"] == 0


@pytest.mark.parametrize("dm", [True, False])
def test_paragraphvectors(dm):
    sents, animals, _ = two_topic_corpus(n=200)
    docs = [pnlp.LabelledDocument(s, ["ANIMALS" if any(w in s for w in animals)
                                      else "TOOLS"]) for s in sents]
    pv = pnlp.ParagraphVectors(dm=dm, train_words=True, device="cpu", **W2V_KW).fit(docs)
    assert set(pv.labels()) == {"ANIMALS", "TOOLS"}
    assert pv.predict("cat dog horse cow dog cat") == "ANIMALS"
    assert pv.predict("hammer wrench saw drill saw") == "TOOLS"
    state = pv._rng.bit_generator.state
    np.testing.assert_array_equal(pv.infer_vector("cat dog", seed=3),
                                  pv.infer_vector("cat dog", seed=3))
    assert pv._rng.bit_generator.state == state


def test_glove_topics():
    sents, animals, tools = two_topic_corpus(n=400)
    g = pnlp.Glove(layer_size=32, window_size=3, epochs=30, batch_size=512,
                   min_word_frequency=1, seed=1, device="cpu").fit(sents)
    assert len(g.loss_history) == 30
    assert g.loss_history[-1] < g.loss_history[0]
    intra, inter = intra_vs_inter(g, animals, tools)
    assert intra > inter, f"intra={intra:.3f} inter={inter:.3f}"


# ------------------------------------------------------------ weights across
def test_model_zip_crosses_both_ways(tmp_path):
    sents, _, _ = two_topic_corpus(n=60)
    jm = jnlp.Word2Vec(**dict(W2V_KW, epochs=3)).fit(sents)
    path = str(tmp_path / "jax.zip")
    jnlp.WordVectorSerializer.write_word2vec_model(jm, path)
    pm = interop.word2vec_from_jax(path, device="cpu")
    assert pm.vocab.words() == jm.vocab.words()
    np.testing.assert_array_equal(pm.get_word_vector_matrix(), np.asarray(jm.syn0))
    for w in ("cat", "saw"):
        assert pm.words_nearest(w, top_n=5) == jm.words_nearest(w, top_n=5)
    assert pm.similarity("cat", "dog") == jm.similarity("cat", "dog")
    sv = interop.sequence_vectors_from_jax(
        jm.vocab.words(), [vw.count for vw in jm.vocab.vocab_words()], np.asarray(jm.syn0),
        np.asarray(jm.syn1), {"layer_size": 32, "negative": 5}, device="cpu")
    assert sv.words_nearest("cat", top_n=5) == jm.words_nearest("cat", top_n=5)
    # the port's files are the JAX package's formats
    pm.fit(sents)
    for write, read in (("write_word2vec_model", "read_word2vec_model"),
                        ("write_word_vectors", "read_word_vectors"),
                        ("write_word2vec_binary", "read_word2vec_binary")):
        p = str(tmp_path / write)
        getattr(pnlp.WordVectorSerializer, write)(pm, p)
        back = getattr(jnlp.WordVectorSerializer, read)(p)
        np.testing.assert_allclose(np.asarray(back.get_word_vector_matrix()),
                                   pm.get_word_vector_matrix(), rtol=1e-5, atol=1e-6)


def test_retrieval_index_from_word2vec():
    """retrieval.build_index over the port's fitted Word2Vec: labels are the
    vocab words, rows are get_word_vector_matrix()."""
    sents, animals, _ = two_topic_corpus(n=60)
    m = pnlp.Word2Vec(device="cpu", **dict(W2V_KW, epochs=3)).fit(sents)
    ix = retrieval.build_index(m, kind="brute", device="cpu")
    assert ix.labels == m.vocab.words()
    ids, _ = ix.search(m.get_word_vector_matrix()[:4], 1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnlp.Word2Vec()
