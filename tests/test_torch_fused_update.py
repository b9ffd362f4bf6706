"""The port's bucketed updater (``optimize/fused_update.py``) against its own
per-tensor path and against the JAX package's ``bucketed_apply``.

The counterparts of tests/test_fused_update.py. The bucketed result must
equal the per-tensor one (``threshold=0``) bitwise, for every updater and
a schedule, with mixed updaters and large leaves, and with counts skewed
by a partial ``pretrain``. Against the JAX package (optax) the port's
updaters are held at rtol 1e-6, as tests/test_torch_training.py holds
them; a fused convolutional graph's ``fit`` (three Nesterovs steps)
against the JAX package's unfused graph at the training tests' float32
tolerances (loss rtol 1e-5, parameters atol 1e-5). The ``cuda`` test runs
the bitwise check on the card, where a tensor divided by a host scalar
rounds as a product with its reciprocal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.optimize import fused_update as jfu
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.nn import training
from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize import updaters as pupd
from deeplearning4j_tpu_torch.optimize.fused_update import bucketed_apply

UPDATERS = [
    ("Sgd", dict(learning_rate=0.05)),
    ("Sgd", dict(learning_rate=0.05, lr_policy="step", lr_decay_rate=0.5,
                 lr_policy_steps=2)),
    ("Nesterovs", dict(learning_rate=0.05, momentum=0.9)),
    ("Adam", dict(learning_rate=0.01)),
    ("Nadam", dict(learning_rate=0.01)),
    ("AdaMax", dict(learning_rate=0.01)),
    ("AdaGrad", dict(learning_rate=0.05)),
    ("RmsProp", dict(learning_rate=0.01)),
    ("AdaDelta", dict()),
]
IDS = [n + ("_schedule" if "lr_policy" in kw else "") for n, kw in UPDATERS]


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's CPU convolution backward crashes in a process that has run
    XLA:CPU programs; the port's CPU path takes native convolutions here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _vertices(rng, keys, big=False):
    shapes = {"W": (5, 3), "b": (3,), "gamma": (3,)}
    out = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
           for k in keys}
    if big:  # above DEFAULT_THRESHOLD: the per-tensor path
        out[keys[1]]["big"] = rng.standard_normal(70000).astype(np.float32)
    return out


def _equal(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _run_both(updaters, params_np, grads_np, device, gnorm=None):
    """(bucketed params, state), (threshold=0 params, state) after one
    step per entry of ``grads_np``."""
    keys = list(params_np)
    gn = {k: pupd.gradient_normalization(gnorm, 5.0) for k in keys}
    out = []
    for threshold in (jfu.DEFAULT_THRESHOLD, 0):
        params = {k: {n: torch.from_numpy(v.copy()).to(device) for n, v in p.items()}
                  for k, p in params_np.items()}
        state = {k: updaters[k].init_state(params[k]) for k in keys}
        for g_np in grads_np:
            grads = {k: {n: torch.from_numpy(v).to(device) for n, v in g.items()}
                     for k, g in g_np.items()}
            bucketed_apply(keys, updaters, gn, params, grads, state, threshold=threshold)
        out.append((params, state))
    return out


@pytest.mark.parametrize("name,kw", UPDATERS, ids=IDS)
def test_bucketed_equals_per_tensor_bitwise_and_optax(name, kw):
    rng = np.random.default_rng(0)
    keys = ["v0", "v1", "v2", "v3"]
    params_np = _vertices(rng, keys)
    grads_np = [{k: {n: rng.standard_normal(v.shape).astype(np.float32)
                     for n, v in p.items()} for k, p in params_np.items()} for _ in range(3)]
    u = getattr(pupd, name)(**kw)
    (p1, s1), (p2, s2) = _run_both({k: u for k in keys}, params_np, grads_np, "cpu")
    assert _equal(p1, p2) and _equal(s1, s2)
    assert s1["v0"]["count"] == 3
    # the JAX package's bucketed_apply on the same numbers
    ju = getattr(jupd, name)(**kw)
    txs = {k: ju.to_optax() for k in keys}
    jp = {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params_np.items()}
    jo = {k: txs[k].init(jp[k]) for k in keys}
    for g in grads_np:
        res = jfu.bucketed_apply(keys, {k: ju for k in keys}, txs,
                                 {k: jupd.gradient_normalization(None) for k in keys},
                                 jp, {k: {n: jnp.asarray(v) for n, v in gk.items()}
                                      for k, gk in g.items()}, jo)
        for k in keys:
            upd, jo[k] = res[k]
            jp[k] = optax.apply_updates(jp[k], upd)
    for k in keys:
        for n in jp[k]:
            np.testing.assert_allclose(p1[k][n].numpy(), np.asarray(jp[k][n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {k}/{n}")


def test_mixed_updaters_and_large_leaves():
    """Layers with other updaters bucket apart, a leaf above the threshold
    and a one-member bucket take the per-tensor path, NoOp layers stay
    exactly as they were, gradient normalization runs first."""
    rng = np.random.default_rng(1)
    keys = ["a", "b", "c", "d", "e"]
    updaters = {"a": pupd.Adam(learning_rate=0.01), "b": pupd.Adam(learning_rate=0.01),
                "c": pupd.Sgd(learning_rate=0.1), "d": pupd.NoOp(),
                "e": pupd.Adam(learning_rate=0.02)}
    params_np = _vertices(rng, keys, big=True)
    grads_np = [{k: {n: rng.standard_normal(v.shape).astype(np.float32)
                     for n, v in p.items()} for k, p in params_np.items()} for _ in range(3)]
    (p1, s1), (p2, s2) = _run_both(updaters, params_np, grads_np, "cpu",
                                   gnorm="clipl2perlayer")
    assert _equal(p1, p2) and _equal(s1, s2)
    for n, v in params_np["d"].items():
        assert np.array_equal(p1["d"][n].numpy(), v)
    assert s1["d"]["count"] == 3
    jups = {"a": jupd.Adam(learning_rate=0.01), "b": jupd.Adam(learning_rate=0.01),
            "c": jupd.Sgd(learning_rate=0.1), "d": jupd.NoOp(),
            "e": jupd.Adam(learning_rate=0.02)}
    txs = {k: u.to_optax() for k, u in jups.items()}
    gns = {k: jupd.gradient_normalization("clipl2perlayer", 5.0) for k in keys}
    jp = {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params_np.items()}
    jo = {k: txs[k].init(jp[k]) for k in keys}
    for g in grads_np:
        res = jfu.bucketed_apply(keys, jups, txs, gns, jp,
                                 {k: {n: jnp.asarray(v) for n, v in gk.items()}
                                  for k, gk in g.items()}, jo)
        for k in keys:
            upd, jo[k] = res[k]
            jp[k] = optax.apply_updates(jp[k], upd)
    for k in keys:
        for n in jp[k]:
            np.testing.assert_allclose(p1[k][n].numpy(), np.asarray(jp[k][n]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k}/{n}")


def _pretrain_net(device="cpu"):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.pretrain import AutoEncoder
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(3).updater(pupd.Adam(learning_rate=0.01))
            .list().layer(AutoEncoder(n_out=6, activation="sigmoid"))
            .layer(DenseLayer(n_out=5, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf, device=device).init()


def test_count_skew_after_partial_pretrain(monkeypatch):
    """A partial pretrain advances one layer's count; the next fit's Adam
    bucket then holds members at counts 2 and 0, each group with its own
    bias corrections: bitwise the per-tensor fit."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(2)
    x = rng.random((10, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    nets = []
    for threshold in (jfu.DEFAULT_THRESHOLD, 0):
        net = _pretrain_net()
        net.pretrain_layer(0, [DataSet(x, y)] * 2)
        assert [s["count"] for s in net.opt_state] == [2, 0, 0]
        with monkeypatch.context() as m:
            m.setattr(training, "bucketed_apply",
                      functools.partial(bucketed_apply, threshold=threshold))
            net.fit([DataSet(x, y)] * 2)
        nets.append(net)
    assert [s["count"] for s in nets[0].opt_state] == [4, 2, 2]
    assert _equal(nets[0].params, nets[1].params)
    assert _equal(nets[0].opt_state, nets[1].opt_state)


SIDE, CLASSES, BATCH = 8, 4, 6


def tiny_conv_conf(updater):
    """The JAX package's configuration of a two-block conv net: stem
    conv(3x3, 8)-BN-relu, blk conv(1x1, 8)-BN-relu, global average pooling
    and a 4-way softmax, on 8 x 8 x 3 images."""
    from deeplearning4j_tpu.models.resnet50 import ResNet50 as JaxResNet50
    from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
    from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JaxGraphBuilder
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOutputLayer
    from deeplearning4j_tpu.nn.conf.network import Builder as JaxBuilder
    from deeplearning4j_tpu.nn.conf.pooling import GlobalPoolingLayer as JaxGlobalPooling
    m = JaxResNet50(num_classes=CLASSES, input_shape=(SIDE, SIDE, 3))
    parent = JaxBuilder()
    parent.seed(7).updater(updater).weight_init("relu")
    g = JaxGraphBuilder(parent)
    g.add_inputs("input")
    x = m._conv_bn(g, "stem", "input", 8, (3, 3))
    x = m._conv_bn(g, "blk", x, 8, (1, 1))
    g.add_layer("avg_pool", JaxGlobalPooling(pooling_type="avg"), x)
    g.add_layer("output", JaxOutputLayer(n_out=CLASSES, activation="softmax",
                                         loss="mcxent"), "avg_pool")
    g.set_outputs("output")
    g.set_input_types(JaxInputType.convolutional(SIDE, SIDE, 3))
    return g.build()


def conv_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32),
            np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, BATCH)])


def port_graph_of(jnet):
    from deeplearning4j_tpu_torch.interop import (graph_conf_from_jax_json, params_from_jax,
                                                  state_from_jax)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    net = ComputationGraph(graph_conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    return net.set_params(params_from_jax(host(jnet.params), device="cpu"),
                          state_from_jax(host(jnet.state), device="cpu"))


def test_fused_conv_graph_fit_matches_jax():
    """The port's fit of the fused two-block conv net (bucketed Nesterovs
    over the gammas, betas and the head's bias) for 3 steps against the
    JAX package's fit of the unfused net."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.perf.fusion import fuse_network

    jnet = JaxGraph(tiny_conv_conf(jupd.Nesterovs(learning_rate=0.05, momentum=0.9))).init()
    pnet = fuse_network(port_graph_of(jnet))
    assert sum(type(o).__name__ == "FusedConvBNActivation"
               for o, _ in pnet.vertices.values()) == 2
    for step in range(3):
        x, y = conv_batch(step)
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score(), float(jnet.score()), rtol=1e-5)
    want = port_graph_of(jnet).params
    got = _unfused_params(pnet)
    for n, p in want.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[n][k], v.numpy(), atol=1e-5, err_msg=f"{n}/{k}")


def _unfused_params(fused):
    """The fused graph's parameters keyed as the unfused graph's: a fused
    block's W / b belong to its conv vertex, gamma / beta to its bn."""
    flat = {}
    for name, p in fused.params.items():
        obj = fused.vertices[name][0]
        if type(obj).__name__ == "FusedConvBNActivation":
            bn = obj.name[:-len("_conv")] + "_bn"
            flat[obj.name] = {k: p[k].numpy() for k in p if k in ("W", "b")}
            flat[bn] = {k: p[k].numpy() for k in ("gamma", "beta")}
        elif p:
            flat[name] = {k: v.numpy() for k, v in p.items()}
    return flat


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", UPDATERS, ids=IDS)
def test_bucketed_equals_per_tensor_bitwise_on_card(cuda_device, name, kw):
    rng = np.random.default_rng(4)
    keys = ["v0", "v1", "v2"]
    params_np = _vertices(rng, keys, big=True)
    grads_np = [{k: {n: rng.standard_normal(v.shape).astype(np.float32)
                     for n, v in p.items()} for k, p in params_np.items()} for _ in range(3)]
    u = getattr(pupd, name)(**kw)
    (p1, s1), (p2, s2) = _run_both({k: u for k in keys}, params_np, grads_np, cuda_device)
    torch.cuda.synchronize()
    assert _equal(p1, p2) and _equal(s1, s2)
