"""The PyTorch port's attention slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages: the
dense ``reference_attention`` and ``flash_self_attention`` (the flash
kernel's plain version on the CPU, the JAX package's dense fallback off the
TPU); ``SelfAttentionLayer`` and ``TransformerEncoderBlock`` with weights
carried by ``interop.params_from_jax``, on the dense path (t = 12) and the
flash path (t = 130), each checking which path counter moved; the masked
dense path; and the small causal transformer LM (vocab 11, width 32, 4
heads, 2 blocks, FFN 64) through ``MultiLayerNetwork.output`` from the JAX
package's JSON, and through ``ParallelInference``.

Tolerances: attention within 1e-6 absolute plus 1e-6 relative (the atol
tests/test_parallel.py holds the JAX pair to; outputs reach |3| and the
score and weight sums run in another order); layer outputs within 2e-5
relative / 2e-6 absolute and the LM's probabilities within 1e-4 relative /
1e-5 absolute, because float32 matmul sums and the tanh GELU round
differently in XLA and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JaxMLC
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import attention as jattn
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu.parallel import ring_attention as jring

from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.conf import attention as pattn
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.recurrent import (EmbeddingLayer,
                                                        EmbeddingSequenceLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.parallel import ring_attention as pring

VOCAB, WIDTH, HEADS, FF = 11, 32, 4, 64


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moved(before):
    return {k: v - before[k] for k, v in pattn.counters.items()}


# ------------------------------------------------------------ attention core
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax(causal):
    q, k, v = (_randn((2, 3, 130, 16), s) for s in (1, 2, 3))
    for port_fn, jax_fn in ((pring.reference_attention, jring.reference_attention),
                            (pring.flash_self_attention, jring.flash_self_attention)):
        got = port_fn(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
        want = np.asarray(jax_fn(*map(jnp.asarray, (q, k, v)), causal=causal))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_key_masked_attention_matches_jax(causal):
    q, k, v = (_randn((2, 3, 130, 16), s) for s in (4, 5, 6))
    mask = np.ones((2, 130), np.float32)
    mask[0, 97:] = 0.0
    mask[1, 5:40] = 0.0
    got = pring.reference_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                    key_mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jring.reference_attention(*map(jnp.asarray, (q, k, v)),
                                                causal=causal, key_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- layers
def _layer_pair(kind, causal, activation="identity"):
    if kind == "self_attention":
        kw = dict(n_in=WIDTH, n_out=WIDTH, n_heads=HEADS, causal=causal,
                  activation=activation)
        return jattn.SelfAttentionLayer(**kw), pattn.SelfAttentionLayer(**kw)
    kw = dict(n_in=WIDTH, n_out=WIDTH, n_heads=HEADS, ff_size=FF, causal=causal,
              activation=activation)
    return jattn.TransformerEncoderBlock(**kw), pattn.TransformerEncoderBlock(**kw)


def _carried(jlayer, t, seed):
    jp = jlayer.init(jax.random.key(seed), JaxInputType.recurrent(WIDTH, t))[0]
    return jp, params_from_jax([_host(jp)], device="cpu")[0]


@pytest.mark.parametrize("kind", ["self_attention", "transformer_block"])
@pytest.mark.parametrize("t,path", [(12, "attention.dense"), (130, "attention.flash")])
@pytest.mark.parametrize("causal", [False, True])
def test_layer_forward_matches_jax(kind, t, path, causal):
    jlayer, player = _layer_pair(kind, causal)
    jp, pp = _carried(jlayer, t, seed=t + causal)
    x = _randn((2, t, WIDTH), 7 + t)
    want = np.asarray(jlayer.apply(jp, {}, jnp.asarray(x))[0])
    before = dict(pattn.counters)
    got, _ = player.apply(pp, {}, torch.from_numpy(x))
    assert _moved(before) == {p: int(p == path) for p in before}
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kind", ["self_attention", "transformer_block"])
def test_masked_dense_path_matches_jax_and_isolates_padding(kind):
    jlayer, player = _layer_pair(kind, causal=False, activation="sigmoid")
    jp, pp = _carried(jlayer, 130, seed=3)
    x = _randn((2, 130, WIDTH), 8)
    mask = np.ones((2, 130), np.float32)
    mask[:, 100:] = 0.0
    mask[1, 60:] = 0.0
    before = dict(pattn.counters)
    out = player.apply(pp, {}, torch.from_numpy(x), mask=torch.from_numpy(mask))[0].numpy()
    assert _moved(before)["attention.dense"] == 1  # a mask takes the dense path
    want = np.asarray(jlayer.apply(jp, {}, jnp.asarray(x), mask=jnp.asarray(mask))[0])
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-6)
    # masked steps emit exact zeros, even after sigmoid
    assert not np.any(out[mask == 0.0])
    # padded content does not reach the steps that are kept
    x2 = x.copy()
    x2[mask == 0.0] += 3.0
    out2 = player.apply(pp, {}, torch.from_numpy(x2), mask=torch.from_numpy(mask))[0].numpy()
    np.testing.assert_array_equal(out2[mask == 1.0], out[mask == 1.0])


def test_embedding_layers_take_integer_ids():
    gen = torch.Generator().manual_seed(0)
    seq = EmbeddingSequenceLayer(n_in=VOCAB, n_out=5)
    p, _ = seq.init(gen, InputType.recurrent(VOCAB), "cpu")
    ids = torch.tensor([[0, 3, 10], [7, 7, 1]], dtype=torch.int32)
    want = p["W"][ids.long()]
    for x in (ids, ids.long(), ids[..., None], ids.float()):
        assert torch.equal(seq.apply(p, {}, x)[0], want)
    emb = EmbeddingLayer(n_in=VOCAB, n_out=5, bias_init=0.5)
    pe, _ = emb.init(gen, InputType.feed_forward(VOCAB), "cpu")
    col = torch.tensor([[2], [9]])
    assert torch.equal(emb.apply(pe, {}, col)[0], pe["W"][[2, 9]] + 0.5)


def test_integer_features_reach_a_dense_network():
    # inputs are taken as float32 whatever their dtype, so uint8 or int
    # features go into a dense first layer as they would as floats
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(2).integers(0, 256, (5, 6)).astype(np.uint8)
    want = net.output(x.astype(np.float32))
    for xi in (x, x.astype(np.int64)):
        assert torch.equal(net.output(xi), want)
    pi = ParallelInference(net, batch_limit=4, device="cpu")
    try:
        np.testing.assert_array_equal(pi.output(x), want.numpy())
        np.testing.assert_array_equal(pi.submit(x.astype(np.int32)).get(timeout=60),
                                      want.numpy())
    finally:
        pi.shutdown()


# ------------------------------------------------------------- the small LM
def _jax_lm(t):
    return (JaxNNC.builder().seed(9).updater(JaxAdam(5e-3)).weight_init("xavier").list()
            .layer(jrec.EmbeddingSequenceLayer(n_in=VOCAB, n_out=WIDTH))
            .layer(jattn.TransformerEncoderBlock(n_heads=HEADS, ff_size=FF, causal=True))
            .layer(jattn.TransformerEncoderBlock(n_heads=HEADS, ff_size=FF, causal=True))
            .layer(jrec.RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(VOCAB, t)).build())


@pytest.fixture(scope="module")
def lm_pair():
    jnet = JaxMLN(_jax_lm(130)).init()
    net = MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    net.params = params_from_jax(_host(jnet.params), device="cpu")
    return jnet, net


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)


@pytest.mark.parametrize("t,path", [(12, "attention.dense"), (130, "attention.flash")])
def test_lm_output_matches_jax(lm_pair, t, path):
    jnet, net = lm_pair
    assert [type(l).__name__ for l in net.layers] == [
        "EmbeddingSequenceLayer", "TransformerEncoderBlock", "TransformerEncoderBlock",
        "RnnOutputLayer"]
    assert set(net.params[1]) == {"q", "k", "v", "o", "ff1", "ff2",
                                  "ln1_g", "ln1_b", "ln2_g", "ln2_b"}
    ids = _ids((3, t), t)
    before = dict(pattn.counters)
    got = net.output(ids)
    assert _moved(before)[path] == 2  # one call per block
    want = jnet.output(ids)
    assert got.shape == (3, t, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(net.predict(ids), np.argmax(want, -1))


def test_lm_features_mask_matches_jax(lm_pair):
    jnet, net = lm_pair
    ids = _ids((2, 20), 4)
    mask = np.ones((2, 20), np.float32)
    mask[0, 14:] = 0.0
    got = net.output(ids, features_mask=mask).numpy()
    want = jnet.output(ids, features_mask=mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the blocks zero the masked steps: the output layer sees zeros there
    np.testing.assert_allclose(got[0, 14:], 1.0 / VOCAB, rtol=1e-6)


def test_port_json_reads_back_in_jax(lm_pair):
    _, net = lm_pair
    back = JaxMLC.from_json(net.conf.to_json())
    assert [type(l).__name__ for l in back.layers] == [
        type(l).__name__ for l in net.conf.layers]
    assert back.layers[1].causal and back.layers[1].ff_size == FF


def test_to_copies_nested_params(lm_pair):
    _, net = lm_pair
    moved = net.to("cpu")
    assert moved.params[1]["q"]["W"] is not net.params[1]["q"]["W"]
    for mine, theirs in zip(moved.params, net.params):
        for key in mine:
            a, b = mine[key], theirs[key]
            if isinstance(a, dict):
                assert all(torch.equal(a[n], b[n]) and a[n].data_ptr() != b[n].data_ptr()
                           for n in a)
            else:
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    ids = _ids((1, 12), 5)
    assert torch.equal(moved.output(ids), net.output(ids))


def test_parallel_inference_serves_the_lm(lm_pair):
    jnet, net = lm_pair
    pi = ParallelInference(net, batch_limit=8, device="cpu")
    try:
        reqs = [_ids((1 + i % 2, 130), 20 + i) for i in range(4)]
        before = dict(pattn.counters)
        obs = [pi.submit(r) for r in reqs]
        outs = [o.get(timeout=60) for o in obs]
        stats = pi.stats()
    finally:
        pi.shutdown()
    for r, out in zip(reqs, outs):
        assert out.shape == (len(r), 130, VOCAB) and out.dtype == np.float32
        np.testing.assert_allclose(out, jnet.output(r), rtol=1e-4, atol=1e-5)
    moved = _moved(before)
    assert moved["attention.flash"] == 2 * stats["batches_dispatched"]
    assert moved["attention.dense"] == 0
    assert stats["requests_served"] == 4
    assert set(stats["attention"]) == {"attention.flash", "attention.dense"}
