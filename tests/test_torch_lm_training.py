"""The PyTorch port's ``MultiLayerNetwork.fit`` against the JAX package, on the CPU.

The small causal LM of tests/test_torch_attention.py (vocab 11, width 32, 4
heads, 2 pre-LN blocks, FFN 64) is built by the JAX package, carried to the
port through its JSON and ``params_from_jax``, and trained through both, at
t = 12 (the dense attention path) and t = 130 (the flash path: on the CPU the
port's ``torch.autograd.Function`` runs the kernels' plain versions, the JAX
package its dense reference), with and without a labels mask. Inputs come
from numpy with fixed seeds. Also: a ``ComputationGraph`` with an attention
vertex (nested q/k/v/o parameters through the updaters, the regularization
and gradient normalization), LeNet on ``synthetic_mnist``, ``fit_fused``,
the refused knobs, and the tiny LM learning a cyclic sequence.

Tolerances:
- losses within rel 1e-5; gradients within rtol 1e-5 + atol 2e-6 (float32
  matmuls and the tanh GELU round differently in XLA and torch; the LM's
  gradients are O(0.1-1), and its measured largest difference is 5e-7);
- one Sgd step: the parameters within the gradient tolerance times the
  learning rate, plus 1 ulp of the weights (rtol 1e-6);
- one Adam step, in units of the learning rate lr: its first update is
  lr * g / (|g| + eps), whose slope in g is at most 1 / (|g| + eps), so a
  gradient that differs by dg moves the update by lr * dg / (|g| + eps), up
  to 2 lr where |g| is float noise (the key bias's gradient is zero in exact
  arithmetic, since softmax ignores a constant per row, and ~1e-8 here).
  Each element is held within lr * min(2, dg / (|g| + eps)), dg the
  gradient tolerance above, plus 1 ulp of the weights;
- bf16 loss within rel 2e-2, as tests/test_torch_training.py holds it;
- LeNet: the same gradient-based Sgd limit; losses over a few epochs within
  rel 1e-4 (float32 convolutions, summed in another order, drift apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.fetchers import synthetic_mnist as jax_synthetic_mnist
from deeplearning4j_tpu.models.lenet import LeNet as JaxLeNet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import attention as jattn
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JaxGraphBuilder
from deeplearning4j_tpu.nn.conf.network import Builder as JaxBuilder
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.datasets import DataSet, synthetic_mnist
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax, state_from_jax,
                                              updater_state_from_jax)
from deeplearning4j_tpu_torch.models import LeNet
from deeplearning4j_tpu_torch.nn.conf import attention as pattn
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves
from deeplearning4j_tpu_torch.optimize import updaters as pupd
from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa

VOCAB, WIDTH, HEADS, FF = 11, 32, 4, 64
G_RTOL, G_ATOL = 1e-5, 2e-6


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes in a process
    that has run XLA:CPU programs (see tests/test_torch_training.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_lm(t, updater, dtype="float32", l2=0.0):
    return (JaxNNC.builder().seed(9).updater(updater).weight_init("xavier").l2(l2)
            .dtype(dtype).list()
            .layer(jrec.EmbeddingSequenceLayer(n_in=VOCAB, n_out=WIDTH))
            .layer(jattn.TransformerEncoderBlock(n_heads=HEADS, ff_size=FF, causal=True))
            .layer(jattn.TransformerEncoderBlock(n_heads=HEADS, ff_size=FF, causal=True))
            .layer(jrec.RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(VOCAB, t)).build())


def _pair(jconf):
    """A JAX network and the port's copy of it (same weights, CPU)."""
    jnet = JaxMLN(jconf).init()
    net = MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    return jnet, net.set_params(params_from_jax(_host(jnet.params), device="cpu"))


def _lm_batch(t, masked, seed=0):
    """Random ids, next-token one-hot labels and (if asked) a labels mask
    that drops the second half of row 0 and the first 3 steps of row 2."""
    ids = np.random.default_rng(seed + t).integers(0, VOCAB, (3, t + 1))
    x = ids[:, :-1].astype(np.int32)
    y = np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]
    lm = None
    if masked:
        lm = np.ones((3, t), np.float32)
        lm[0, t // 2:] = 0.0
        lm[2, :3] = 0.0
    return x, y, lm


def _jax_loss_and_grads(jnet, x, y, lm):
    (loss, _), grads = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None,
        None if lm is None else jnp.asarray(lm))
    return float(loss), _host(grads)


def _leaves(tree, path=""):
    """{path: numpy array} for every leaf of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, e in enumerate(tree) for k, v in _leaves(e, f"{path}/{i}").items()}
    return {path: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _pairs(got, want):
    """(path, port leaf, JAX leaf) for every leaf of two trees."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    return [(path, g[path], w[path]) for path in sorted(w)]


def _assert_grads(got, want):
    for path, g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=G_RTOL, atol=G_ATOL, err_msg=path)


def _assert_step(kind, before, after_port, after_jax, grads, lr):
    """Parameters after one step, within the limits the docstring states."""
    g = _leaves(grads)
    assert sorted(g) == sorted(_leaves(before))
    for path, p, w in _pairs(after_port, after_jax):
        dg = G_ATOL + G_RTOL * np.abs(g[path])
        if kind == "Sgd":
            limit = lr * dg
        else:
            limit = lr * np.minimum(2.0, dg / (np.abs(g[path]) + 1e-8))
        limit = limit + 1e-6 * np.abs(w)
        assert np.all(np.abs(p - w) <= limit), (kind, path, float(np.abs(p - w).max()))


def _moved(before):
    return {k: v - before[k] for k, v in pattn.counters.items()}


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("t,path", [(12, "attention.dense"), (130, "attention.flash")])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_gradients_match_jax(t, path, masked):
    jnet, net = _pair(_jax_lm(t, jupd.Sgd(0.1)))
    x, y, lm = _lm_batch(t, masked)
    jl, jg = _jax_loss_and_grads(jnet, x, y, lm)
    before = dict(pattn.counters)
    pl, pg, _ = net._loss_and_grads(net._as_input(x), net._as_labels(y), None, None,
                                    None if lm is None else net._as_input(lm))
    assert _moved(before) == {p: 2 * (p == path) for p in before}  # one per block
    assert float(pl) == pytest.approx(jl, rel=1e-5)
    _assert_grads(pg, jg)


def test_flash_path_gradients_reach_q_k_v():
    # the attention weights train through the flash entry at t = 130: every
    # gradient of W_q, W_k and W_v is non-zero and matches JAX
    jnet, net = _pair(_jax_lm(130, jupd.Sgd(0.1)))
    x, y, _ = _lm_batch(130, False, seed=5)
    _, jg = _jax_loss_and_grads(jnet, x, y, None)
    dkv, dq = fa.launches_bwd_dkv, fa.launches_bwd_dq
    _, pg, _ = net._loss_and_grads(net._as_input(x), net._as_labels(y))
    assert (fa.launches_bwd_dkv, fa.launches_bwd_dq) == (dkv, dq)  # plain versions
    for block in (1, 2):
        for group in ("q", "k", "v"):
            g = pg[block][group]["W"].numpy()
            assert np.all(g != 0.0), (block, group)
            np.testing.assert_allclose(g, jg[block][group]["W"], rtol=G_RTOL, atol=G_ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash backward kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_path_gradients_on_the_card_match_the_cpu(cuda_device):
    jconf = _jax_lm(130, jupd.Sgd(0.1))
    _, net = _pair(jconf)
    card = net.to(cuda_device)
    x, y, _ = _lm_batch(130, False, seed=5)
    counts = (fa.launches, fa.launches_bwd_dkv, fa.launches_bwd_dq)
    _, gg, _ = card._loss_and_grads(card._as_input(x), card._as_labels(y))
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_bwd_dkv, fa.launches_bwd_dq) == tuple(
        c + 2 for c in counts)
    _, pg, _ = net._loss_and_grads(net._as_input(x), net._as_labels(y))
    for block in (1, 2):
        for group in ("q", "k", "v"):
            g = gg[block][group]["W"].cpu().numpy()
            assert np.all(g != 0.0)
            np.testing.assert_allclose(g, pg[block][group]["W"].numpy(), rtol=1e-4,
                                       atol=1e-5)


# ------------------------------------------------------------- one step, fit
@pytest.mark.parametrize("t", [12, 130])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind,lr", [("Sgd", 0.1), ("Adam", 5e-3)])
def test_lm_one_step_through_fit_matches_jax(t, masked, kind, lr):
    jnet, net = _pair(_jax_lm(t, getattr(jupd, kind)(learning_rate=lr)))
    x, y, lm = _lm_batch(t, masked, seed=1)
    _, jg = _jax_loss_and_grads(jnet, x, y, lm)
    before = _host(jnet.params)
    jnet.fit(JaxDataSet(x, y, labels_mask=lm))
    net.fit(DataSet(x, y, labels_mask=lm))
    assert net.iteration == 1 and net.epoch == 1 and net.last_batch_size == 3
    assert net.score() == pytest.approx(float(jnet.score()), rel=1e-5)
    _assert_step(kind, before, net.params, _host(jnet.params), jg, lr)


def test_adam_state_carried_from_jax_steps_like_optax():
    # a nested layer's Adam state after one JAX step, carried to the port:
    # two more updates with the same gradients match optax's
    jnet, net = _pair(_jax_lm(12, jupd.Adam(learning_rate=5e-3)))
    x, y, _ = _lm_batch(12, False, seed=2)
    jnet.fit(JaxDataSet(x, y))
    adam = jnet.opt_state[1][0]
    state = updater_state_from_jax(adam.count, {"mu": _host(adam.mu), "nu": _host(adam.nu)},
                                   device="cpu")
    assert state["count"] == 1 and set(state["mu"]["q"]) == {"W", "b"}
    tx, jstate = jupd.Adam(learning_rate=5e-3).to_optax(), jnet.opt_state[1]
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), _host(adam.mu))
        want, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate)
        got, state = net._updaters[1].update(params_from_jax([g], "cpu")[0], state)
        for path, u, w in _pairs(got, _host(want)):
            np.testing.assert_allclose(u, w, rtol=1e-6, atol=1e-9, err_msg=path)
    assert state["count"] == 3


def test_bf16_loss_matches_jax():
    jnet, net = _pair(_jax_lm(130, jupd.Sgd(0.1), dtype="bfloat16"))
    assert net._dtype == torch.bfloat16
    x, y, lm = _lm_batch(130, True, seed=4)
    jl, _ = _jax_loss_and_grads(jnet, x, y, lm)
    pl, pg, _ = net._loss_and_grads(net._as_input(x), net._as_labels(y), None, None,
                                    net._as_input(lm))
    assert float(pl) == pytest.approx(jl, rel=2e-2)
    # gradients land on the float32 masters
    assert all(g.dtype == torch.float32 for g in tree_leaves(pg))


def test_fit_fused_equals_fit_bitwise():
    _, a = _pair(_jax_lm(130, jupd.Adam(learning_rate=5e-3)))
    b, c = a.to("cpu"), a.to("cpu")
    batches = [_lm_batch(130, masked=i == 1, seed=10 + i) for i in range(3)]
    for x, y, lm in batches:
        a.fit(DataSet(x, y, labels_mask=lm))
    b.fit_fused([DataSet(x, y, labels_mask=lm) for x, y, lm in batches])
    xs = np.stack([x for x, _, _ in batches])
    ys = np.stack([y for _, y, _ in batches])
    c.fit_fused((xs, ys))
    assert b.iteration == 3 and b.score() == a.score()
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    # the stacked form has no mask: it equals fit on maskless batches
    d = _pair(_jax_lm(130, jupd.Adam(learning_rate=5e-3)))[1]
    for x, y in zip(xs, ys):
        d.fit(x, y)
    for p, q in zip(tree_leaves(c.params), tree_leaves(d.params)):
        assert torch.equal(p, q)


def test_tiny_causal_transformer_lm_learns():
    """The port's counterpart of tests/test_attention.py's test: the same
    data, model and thresholds, 150 epochs through fit."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.attention import TransformerEncoderBlock
    from deeplearning4j_tpu_torch.nn.conf.recurrent import (EmbeddingSequenceLayer,
                                                            RnnOutputLayer)

    vocab, t, width = 7, 16, 32
    rng = np.random.default_rng(4)
    starts = rng.integers(0, vocab, 64)
    ids = (starts[:, None] + np.arange(t + 1)[None, :]) % vocab
    x_ids = ids[:, :-1]
    y = np.eye(vocab, dtype=np.float32)[ids[:, 1:]]
    conf = (NeuralNetConfiguration.builder()
            .seed(9).updater(pupd.Adam(5e-3)).weight_init("xavier").list()
            .layer(EmbeddingSequenceLayer(n_in=vocab, n_out=width))
            .layer(TransformerEncoderBlock(n_heads=4, ff_size=64, causal=True))
            .layer(RnnOutputLayer(n_out=vocab, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(vocab, t)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    ds = DataSet(x_ids.astype(np.int32), y)
    s0 = net.score_dataset(ds)
    net.fit(ds, num_epochs=150)
    assert net.score_dataset(ds) < s0 * 0.2
    pred = net.predict(x_ids.astype(np.int32))
    acc = float(np.mean(pred[:, 1:] == ids[:, 2:]))  # skip cold position 0
    assert acc > 0.9, acc


def test_score_dataset_matches_jax():
    jnet, net = _pair(_jax_lm(12, jupd.Sgd(0.1), l2=1e-3))
    x, y, lm = _lm_batch(12, True, seed=6)
    want = jnet.score_dataset(JaxDataSet(x, y, labels_mask=lm))
    assert net.score_dataset(DataSet(x, y, labels_mask=lm)) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("knob", ["bucket_policy", "prefetch", "checkpoint_manager",
                                  "grad_compression", "augmentation", "solver"])
def test_refused_knobs_raise(knob):
    """Gradient compression and a sharded checkpoint manager raise
    NotImplementedError and train nothing. bucket_policy, prefetch and
    augmentation are ported: fit and fit_fused take them and train, and an
    augmentation of a 2-D id input raises ValueError as the JAX package's
    does. The full-batch solvers are ported: fit runs them, and fit_fused
    raises the JAX package's ValueError."""
    jconf = _jax_lm(12, jupd.Sgd(0.1))
    if knob == "solver":
        jconf = dataclasses.replace(jconf, optimization_algo="lbfgs")
    net = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu").init()
    x, y, _ = _lm_batch(12, False)
    ds = DataSet(x, y)
    if knob in ("bucket_policy", "prefetch"):
        net.fit(ds, **{knob: True})
        net.fit_fused([ds], bucket_policy=True)
        assert net.iteration == 2
        return
    if knob == "augmentation":
        from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
        aug = ImageAugmentation(flip_prob=0.5)
        assert net.set_augmentation(aug) is net and net.augmentation is aug
        with pytest.raises(ValueError, match="NHWC"):
            net.fit(ds)
        assert net.iteration == 0
        return
    if knob == "solver":
        with pytest.raises(ValueError, match="SGD-family"):
            net.fit_fused([ds])
        assert net.iteration == 0
        before = net.score_dataset(ds)
        net.fit(ds)
        assert net.iteration == 1 and np.isfinite(net.score()) and net.score() < before
        return
    with pytest.raises(NotImplementedError):
        if knob == "checkpoint_manager":
            # fit takes a checkpoint manager now; its sharded form is not ported
            from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager,
                                                             ObjectStoreBackend)
            net.fit(ds, checkpoint_manager=CheckpointManager(
                storage=ObjectStoreBackend(), sharded=True, device="cpu"))
        elif knob == "grad_compression":
            net.grad_compression = object()
            net.fit(ds)
        else:
            net.fit(ds)
    if knob != "checkpoint_manager":
        with pytest.raises(NotImplementedError):
            net.fit_fused([ds], bucket_policy=True)
    assert net.iteration == 0


def test_dataset_keeps_tensors_as_tensors():
    x = torch.arange(12.0).reshape(6, 2)
    y = torch.eye(6)
    ds = DataSet(x.clone(), y.clone(), labels_mask=torch.ones(6))
    ds.shuffle(np.random.default_rng(1))
    idx = np.random.default_rng(1).permutation(6)
    assert torch.equal(ds.features, x[idx]) and torch.equal(ds.labels, y[idx])
    parts = ds.split(4)
    assert [p.num_examples() for p in parts] == [4, 2]
    assert all(isinstance(p.features, torch.Tensor) for p in parts)
    back = DataSet.merge(parts)
    assert torch.equal(back.features, ds.features) and torch.equal(back.labels_mask,
                                                                   torch.ones(6))


# ------------------------------------------------- a graph with attention (C1)
def _jax_attention_graph(updater, l2=0.0, l2_bias=0.0, gnorm=None, has_bias=True):
    parent = JaxBuilder()
    parent.seed(3).updater(updater).weight_init("xavier")
    g = JaxGraphBuilder(parent)
    g.add_inputs("in")
    g.add_layer("att", jattn.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2, l2=l2,
                                                l2_bias=l2_bias, bias_init=0.1,
                                                gradient_normalization=gnorm,
                                                has_bias=has_bias), "in")
    g.add_layer("out", jrec.RnnOutputLayer(n_out=5, activation="softmax", loss="mcxent"),
                "att")
    g.set_outputs("out")
    g.set_input_types(JaxInputType.recurrent(8, 6))
    return JaxGraph(g.build()).init()


def _graph_port(jnet):
    net = ComputationGraph(graph_conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    return net.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                          state_from_jax(_host(jnet.state), device="cpu"))


def _graph_batch():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 6))]
    return x, y


@pytest.mark.parametrize("kind,lr", [("Sgd", 0.1), ("Adam", 1e-2)])
def test_graph_with_attention_vertex_trains_like_jax(kind, lr):
    jnet = _jax_attention_graph(getattr(jupd, kind)(learning_rate=lr))
    net = _graph_port(jnet)
    if kind == "Adam":  # the slots mirror the nested groups
        assert set(net.opt_state["att"]["mu"]) == {"q", "k", "v", "o"}
    x, y = _graph_batch()
    (_, _), jg = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)], None, None, None)
    before = _host(jnet.params)
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    assert net.num_params() == 4 * (8 * 8 + 8) + 8 * 5 + 5
    _assert_step(kind, before, net.params, _host(jnet.params), _host(jg), lr)


def test_graph_regularization_reaches_nested_paths():
    jnet = _jax_attention_graph(jupd.Sgd(0.1), l2=1e-2, l2_bias=3e-2)
    net = _graph_port(jnet)
    want = float(jnet._regularization(jnet.params))
    got = float(net._regularization(net.params))
    assert got == pytest.approx(want, rel=1e-6)
    p = net.params["att"]
    by_hand = sum(0.5 * 1e-2 * float((p[g]["W"] ** 2).sum())
                  + 0.5 * 3e-2 * float((p[g]["b"] ** 2).sum()) for g in "qkvo")
    assert got == pytest.approx(by_hand, rel=1e-6) and got > 0


@pytest.mark.parametrize("kind", ["RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
                                  "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
                                  "ClipL2PerParamType"])
def test_gradient_normalization_walks_nested_trees(kind):
    rng = np.random.default_rng(9)
    g = {"q": {"W": rng.standard_normal((4, 4)).astype(np.float32),
               "b": rng.standard_normal(4).astype(np.float32)},
         "ln_g": rng.standard_normal(4).astype(np.float32)}
    want = _host(jupd.gradient_normalization(kind, 0.5)(
        jax.tree_util.tree_map(jnp.asarray, g)))
    got = pupd.gradient_normalization(kind, 0.5)(params_from_jax([g], "cpu")[0])
    for path, a, b in _pairs(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=path)
    # and a graph layer with it trains like JAX's; without biases: the key
    # bias's gradient is zero in exact arithmetic, and a per-param-type
    # renormalization would blow its float noise up to a unit vector
    jnet = _jax_attention_graph(jupd.Sgd(0.1), gnorm=kind, has_bias=False)
    net = _graph_port(jnet)
    x, y = _graph_batch()
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    for path, a, b in _pairs(net.params, _host(jnet.params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=path)


# -------------------------------------------------------------------- LeNet
def _lenet_pair(updater_kind, lr):
    jconf = JaxLeNet(updater=getattr(jupd, updater_kind)(learning_rate=lr)).conf()
    jnet, net = _pair(jconf)
    port_conf = LeNet(updater=getattr(pupd, updater_kind)(learning_rate=lr)).conf()
    assert port_conf.to_json() == net.conf.to_json()
    return jnet, net


def test_synthetic_mnist_is_the_jax_packages():
    for a, b in zip(synthetic_mnist(40, seed=5), jax_synthetic_mnist(40, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_lenet_sgd_step_and_epochs_match_jax():
    jnet, net = _lenet_pair("Sgd", 0.05)
    x, y = synthetic_mnist(16, seed=1)
    (_, _), jg = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None, None)
    before = _host(jnet.params)
    jnet.fit(x, y)
    net.fit(x, y)
    _assert_step("Sgd", before, net.params, _host(jnet.params), _host(jg), 0.05)
    # a few epochs over two batches: the losses fall together
    batches = [synthetic_mnist(16, seed=s) for s in (2, 3)]
    losses = []
    for _ in range(3):
        for bx, by in batches:
            jnet.fit(bx, by)
            net.fit(bx, by)
            losses.append((float(jnet.score()), net.score()))
    for jl, pl in losses:
        assert pl == pytest.approx(jl, rel=1e-4)
    assert losses[-1][1] < losses[0][1]
