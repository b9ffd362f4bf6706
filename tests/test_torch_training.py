"""The PyTorch port's training slice against the JAX package, on the CPU.

A ResNet-shaped graph (16x16x3 input; stem conv-BN-relu with 8 channels,
one bottleneck conv block and one identity block of widths 8/8/16, global
average pooling, 10 classes, l2 1e-4) is built by the JAX package's
ResNet50 block helpers, carried to the port through its JSON and
``params_from_jax`` / ``state_from_jax``, and trained through both, unfused
and fused (``conf.fused()`` / ``fuse_network``). Inputs come from numpy
with fixed seeds.

Tolerances: float32 losses rtol 1e-5 and gradients atol 1e-5, as
tests/test_fusion.py holds the JAX package's own fused/unfused pair (torch
and XLA sum convolutions and batch statistics in other orders); bf16 loss
rtol 2e-2 (bf16 keeps 8 bits and the two frameworks round at other
points). Updaters are held to optax at rtol 1e-6: the same algebra, with
bias corrections that may round differently in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.resnet50 import ResNet50 as JaxResNet50
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JaxGraphBuilder
from deeplearning4j_tpu.nn.conf.graph import ComputationGraphConfiguration as JaxCGC
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOutputLayer
from deeplearning4j_tpu.nn.conf.network import Builder as JaxBuilder
from deeplearning4j_tpu.nn.conf.pooling import GlobalPoolingLayer as JaxGlobalPooling
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.perf.fusion import fuse_network as jax_fuse_network

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import (graph_conf_from_jax_json, params_from_jax,
                                              state_from_jax)
from deeplearning4j_tpu_torch.models import ResNet50
from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.optimize import updaters as pupd
from deeplearning4j_tpu_torch.perf.fusion import fuse_network

SIDE, CLASSES, BATCH = 16, 10, 6


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes (SIGSEGV) in
    a process that has run XLA:CPU programs; the port's CPU path takes
    PyTorch's native convolutions in this file."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _small_conf(updater, dtype="float32"):
    m = JaxResNet50(num_classes=CLASSES, input_shape=(SIDE, SIDE, 3))
    parent = JaxBuilder()
    parent.seed(7).updater(updater).weight_init("relu").l2(1e-4).dtype(dtype)
    g = JaxGraphBuilder(parent)
    g.add_inputs("input")
    x = m._conv_bn(g, "stem", "input", 8, (3, 3))
    x = m._conv_block(g, "res2a", x, (8, 8, 16), stride=(2, 2))
    x = m._identity_block(g, "res2b", x, (8, 8, 16))
    g.add_layer("avg_pool", JaxGlobalPooling(pooling_type="avg"), x)
    g.add_layer("output", JaxOutputLayer(n_out=CLASSES, activation="softmax",
                                         loss="mcxent"), "avg_pool")
    g.set_outputs("output")
    g.set_input_types(JaxInputType.convolutional(SIDE, SIDE, 3))
    return g.build()


def _host(tree):
    return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in tree.items()}


def _port_of(jnet):
    net = ComputationGraph(graph_conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    return net.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                          state_from_jax(_host(jnet.state), device="cpu"))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, BATCH)]
    return x, y


def _jax_loss_and_grads(jnet, x, y):
    (loss, state), grads = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)], None, None, None)
    return float(loss), _host(grads), _host(state)


def _port_loss_and_grads(pnet, x, y):
    loss, grads, state = pnet._loss_and_grads([torch.from_numpy(x)],
                                              [torch.from_numpy(y)])
    return float(loss), grads, state


def _assert_trees(got, want, what, **tol):
    got = {n: p for n, p in got.items() if p}  # vertices without tensors drop out
    want = {n: p for n, p in want.items() if p}
    assert sorted(got) == sorted(want), what
    for n in want:
        assert sorted(got[n]) == sorted(want[n]), (what, n)
        for k in want[n]:
            np.testing.assert_allclose(np.asarray(got[n][k].detach()), want[n][k],
                                       err_msg=f"{what} {n}/{k}", **tol)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxGraph(_small_conf(jupd.Sgd(learning_rate=0.05))).init()
    jfused = jax_fuse_network(jnet)
    return {"jnet": jnet, "jfused": jfused}


def test_graph_conf_json_round_trips_both_ways(nets):
    for key in ("jnet", "jfused"):
        s = nets[key].conf.to_json()
        assert graph_conf_from_jax_json(s).to_json() == s
        assert JaxCGC.from_json(graph_conf_from_jax_json(s).to_json()).to_json() == s


@pytest.mark.parametrize("fused", [False, True])
def test_loss_grads_step_state_and_eval_match_jax(nets, fused):
    jnet = nets["jfused" if fused else "jnet"]
    pnet = _port_of(jnet)
    if fused:
        assert sum(isinstance(o, FusedConvBNActivation)
                   for o, _ in pnet.vertices.values()) == 8
    x, y = _batch(1)
    jl, jg, jstate = _jax_loss_and_grads(jnet, x, y)
    pl, pg, pstate = _port_loss_and_grads(pnet, x, y)
    assert pl == pytest.approx(jl, rel=1e-5)
    _assert_trees(pg, jg, "grad", rtol=0, atol=1e-5)
    _assert_trees(pstate, jstate, "state", rtol=1e-5, atol=1e-6)
    # one Sgd step through fit, on copies of both nets
    jstep = JaxGraph(jnet.conf).init()
    # copies: the JAX step donates its buffers
    jstep.params, jstep.state = jax.tree_util.tree_map(jnp.array, (jnet.params, jnet.state))
    jstep.opt_state = {n: jstep._txs[n].init(jstep.params[n]) for n in jstep._layer_names}
    jstep.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.score() == pytest.approx(float(jstep._score), rel=1e-5)
    _assert_trees(pnet.params, _host(jstep.params), "params after a step",
                  rtol=1e-5, atol=1e-6)
    _assert_trees(pnet.state, _host(jstep.state), "running stats after a step",
                  rtol=1e-5, atol=1e-6)
    xe, _ = _batch(2)
    np.testing.assert_allclose(pnet.output_single(xe), jstep.output_single(xe),
                               rtol=1e-5, atol=1e-6)


def test_fused_port_matches_jax_unfused(nets):
    """fuse_network in the port maps the JAX unfused net's weights onto the
    fused layout; loss and gradients agree with the JAX unfused net."""
    jnet = nets["jnet"]
    pfused = fuse_network(_port_of(jnet))
    assert pfused.conf.to_json() == nets["jfused"].conf.to_json()
    x, y = _batch(3)
    jl, jg, _ = _jax_loss_and_grads(jnet, x, y)
    pl, pg, _ = _port_loss_and_grads(pfused, x, y)
    assert pl == pytest.approx(jl, rel=1e-5)
    for name, (obj, _) in pfused.vertices.items():
        if not isinstance(obj, FusedConvBNActivation):
            _assert_trees({name: pg[name]}, {name: jg[name]}, "grad", rtol=0, atol=1e-5)
            continue
        conv = obj.name  # the fused block keeps the conv's layer name
        bn = conv[:-len("_conv")] + "_bn"
        want = dict(jg[conv], gamma=jg[bn]["gamma"], beta=jg[bn]["beta"])
        _assert_trees({name: pg[name]}, {name: want}, "grad", rtol=0, atol=1e-5)


def test_bf16_loss_matches_jax():
    conf = _small_conf(jupd.Sgd(learning_rate=0.05), dtype="bfloat16").fused()
    jnet = JaxGraph(conf).init()
    pnet = _port_of(jnet)
    assert pnet._dtype == torch.bfloat16
    x, y = _batch(4)
    jl, _, _ = _jax_loss_and_grads(jnet, x, y)
    pl, pg, _ = _port_loss_and_grads(pnet, x, y)
    assert pl == pytest.approx(jl, rel=2e-2)
    # gradients land on the float32 masters
    assert all(g.dtype == torch.float32 for p in pg.values() for g in p.values())


UPDATERS = [
    ("Sgd", dict(learning_rate=0.1)),
    ("Nesterovs", dict(learning_rate=0.1, momentum=0.9)),
    ("Adam", dict(learning_rate=1e-2)),
    ("AdaMax", dict(learning_rate=1e-2)),
    ("Nadam", dict(learning_rate=1e-2)),
    ("AdaGrad", dict(learning_rate=0.1)),
    ("RmsProp", dict(learning_rate=0.1)),
    ("AdaDelta", dict(rho=0.9)),
    ("NoOp", dict()),
]


@pytest.mark.parametrize("name,kw", UPDATERS)
def test_updater_matches_optax_for_three_steps(name, kw):
    rng = np.random.default_rng(11)
    params = {"W": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jup = getattr(jupd, name)(**kw)
    pup = pupd.Updater.from_dict(jup.to_dict())
    assert pup == getattr(pupd, name)(**kw) and pup.to_dict() == jup.to_dict()
    tx = jup.to_optax()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = pup.init_state(pp)
    for g in grads:
        u, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, u)
        pu, pstate = pup.update({k: torch.from_numpy(v) for k, v in g.items()}, pstate)
        pp = {k: pp[k] + pu[k] for k in pp}
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=f"{name} {k}")


def test_lr_schedule_matches_jax():
    kw = dict(learning_rate=0.1, lr_policy="step", lr_decay_rate=0.5, lr_policy_steps=2.0)
    sched = jupd.Sgd(**kw)._lr()
    p = pupd.Sgd(**kw)
    for step in range(6):
        assert p.lr(step) == pytest.approx(float(sched(step)), rel=1e-6)


@pytest.mark.parametrize("kind", ["renormalizel2perlayer", "clipl2perlayer",
                                  "clipelementwiseabsolutevalue", "clipl2perparamtype"])
def test_gradient_normalization_matches_jax(kind):
    rng = np.random.default_rng(5)
    g = {"W": rng.standard_normal((5, 4)).astype(np.float32) * 3,
         "b": rng.standard_normal(4).astype(np.float32)}
    want = jupd.gradient_normalization(kind, 0.5)({k: jnp.asarray(v) for k, v in g.items()})
    got = pupd.gradient_normalization(kind, 0.5)({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_full_size_resnet50_confs_match_jax():
    """ResNet50 at full width, conf only: the JSON of both packages is the
    same, unfused and fused; 53 blocks fuse, 16 with the residual add."""
    jconf = JaxResNet50().conf()
    pconf = ResNet50().conf()
    assert pconf.to_json() == jconf.to_json()
    assert graph_conf_from_jax_json(jconf.to_json()).to_json() == jconf.to_json()
    jf, pf = jconf.fused(), pconf.fused()
    assert pf.to_json() == jf.to_json()
    assert list(pf.vertices) == list(jf.vertices)
    fused = [o for o, _ in pf.vertices.values() if isinstance(o, FusedConvBNActivation)]
    assert len(fused) == 53
    assert sum(o.residual for o in fused) == 16
    assert ComputationGraph(pf, device="cpu").order == JaxGraph(jf).order


def test_fit_lowers_the_loss_on_a_fixed_batch():
    net = ResNet50(num_classes=CLASSES, input_shape=(SIDE, SIDE, 3),
                   updater=pupd.Adam(learning_rate=1e-3))
    conf = dataclasses.replace(net.conf().fused(), seed=3)
    pnet = ComputationGraph(conf, device="cpu").init()
    x, y = _batch(6)
    ds = DataSet(x, y)
    s0 = pnet.score_dataset(ds)
    pnet.fit([ds, ds, ds], num_epochs=2)
    assert pnet.iteration == 6 and pnet.epoch == 2
    assert pnet.score_dataset(ds) < s0
    assert pnet.output_single(x).shape == (BATCH, CLASSES)


def test_unported_training_options_raise():
    """Prefetch, augmentation and gradient compression are ported and
    train the graph (the last with its error-feedback state advancing)."""
    from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
    pnet = ComputationGraph(ResNet50(num_classes=3, input_shape=(8, 8, 3)).conf(),
                            device="cpu").init()
    x, y = np.zeros((2, 8, 8, 3), np.float32), np.eye(3, dtype=np.float32)[[0, 1]]
    pnet.fit(DataSet(x, y), prefetch=True)
    assert pnet.set_augmentation(ImageAugmentation(crop_padding=1)) is pnet
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == 2
    from deeplearning4j_tpu_torch.parallel import Int8Compression, enable_grad_compression
    enable_grad_compression(pnet, Int8Compression())
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == 3 and float(pnet.compress_state["acc"]["steps"]) == 1.0


LOSS_CASES = [(name, act) for name in ("mse", "l1", "mcxent", "xent", "kld", "poisson",
                                        "cosine_proximity", "hinge", "squared_hinge",
                                        "mape", "msle", "negativeloglikelihood",
                                        "reconstruction_crossentropy")
              for act in ("softmax", "sigmoid", "identity")]


@pytest.mark.parametrize("name,act", LOSS_CASES)
def test_losses_match_jax(name, act):
    from deeplearning4j_tpu.nn import lossfunctions as jloss
    from deeplearning4j_tpu_torch.nn import lossfunctions as ploss

    rng = np.random.default_rng(len(name) * 7 + len(act))
    preout = rng.standard_normal((5, 4)).astype(np.float32)
    labels = rng.uniform(0.05, 1.0, (5, 4)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    weights = (0.5, 1.0, 2.0, 1.5)
    for m, w in ((None, None), (mask, weights)):
        want = jloss.score(name, jnp.asarray(labels), jnp.asarray(preout), act,
                           None if m is None else jnp.asarray(m), w)
        got = ploss.score(name, torch.from_numpy(labels), torch.from_numpy(preout), act,
                          None if m is None else torch.from_numpy(m), w)
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("collapse", [True, False])
def test_global_pooling_matches_jax(pooling, collapse):
    from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer

    x = np.random.default_rng(9).standard_normal((3, 5, 4, 6)).astype(np.float32)
    for shape in ((3, 5, 4, 6), (3, 7, 6)):
        xs = x.reshape(-1)[:int(np.prod(shape))].reshape(shape)
        want, _ = JaxGlobalPooling(pooling_type=pooling, pnorm=3,
                                   collapse_dimensions=collapse).apply({}, {}, jnp.asarray(xs))
        got, _ = GlobalPoolingLayer(pooling_type=pooling, pnorm=3,
                                    collapse_dimensions=collapse).apply({}, {}, torch.from_numpy(xs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


VERTEX_CASES = [("ElementWiseVertex", dict(op=op), 2) for op in
                ("add", "subtract", "product", "average", "max")] + [
    ("MergeVertex", {}, 2), ("StackVertex", {}, 2), ("UnstackVertex", dict(from_index=1,
                                                                           stack_size=2), 1),
    ("SubsetVertex", dict(from_index=1, to_index=3), 1), ("ReshapeVertex", dict(shape=(2, 6)), 1),
    ("ScaleVertex", dict(scale=2.5), 1), ("ShiftVertex", dict(shift=-0.5), 1),
    ("L2NormalizeVertex", {}, 1), ("L2Vertex", {}, 2)]


@pytest.mark.parametrize("cls,kw,arity", VERTEX_CASES)
def test_graph_vertices_match_jax(cls, kw, arity):
    from deeplearning4j_tpu.nn.conf import graph as jgraph
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph

    rng = np.random.default_rng(13)
    xs = [rng.standard_normal((4, 12)).astype(np.float32) for _ in range(arity)]
    jv, pv = getattr(jgraph, cls)(**kw), getattr(pgraph, cls)(**kw)
    assert pgraph.vertex_from_dict(jv.to_dict()) == pv
    want = jv.apply(*[jnp.asarray(x) for x in xs])
    got = pv.apply(*[torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act,param", [("relu", None), ("leakyrelu", 0.2), ("elu", 0.7),
                                       ("tanh", None)])
def test_activation_layer_matches_jax(act, param):
    from deeplearning4j_tpu.nn.conf.layers import ActivationLayer as JaxActivationLayer
    from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer

    x = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    want, _ = JaxActivationLayer(activation=act, activation_param=param).apply(
        {}, {}, jnp.asarray(x))
    got, _ = ActivationLayer(activation=act, activation_param=param).apply(
        {}, {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_fuse_network_multilayer_matches_jax():
    """A conv-BN-act stack in a MultiLayerNetwork: the port's fused conf is
    the JAX package's, and fuse_network keeps the eval output."""
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
    from deeplearning4j_tpu.nn.conf import convolutional as jconv
    from deeplearning4j_tpu.nn.conf.layers import ActivationLayer as JaxActivationLayer
    from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization as JaxBN
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
    from deeplearning4j_tpu_torch.interop import conf_from_jax_json
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (JaxNNC.builder().seed(3).weight_init("relu").list()
            .layer(jconv.ConvolutionLayer(n_out=6, kernel_size=(3, 3), has_bias=False,
                                          convolution_mode="same"))
            .layer(JaxBN())
            .layer(JaxActivationLayer(activation="leakyrelu"))
            .layer(JaxOutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(6, 6, 2)).build())
    jnet = JaxMLN(conf).init()
    pnet = MultiLayerNetwork(conf_from_jax_json(conf.to_json()), device="cpu")
    pnet.params = params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                   for p in jnet.params], device="cpu")
    pnet.state = state_from_jax([{k: np.asarray(v) + 0.25 for k, v in s.items()}
                                 for s in jnet.state], device="cpu")
    pfused = fuse_network(pnet)
    assert pfused.conf.to_json() == conf.fused().to_json()
    assert [type(l).__name__ for l in pfused.layers] == ["FusedConvBNActivation",
                                                         "OutputLayer"]
    x = np.random.default_rng(8).standard_normal((3, 6, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(pfused.output(x).numpy(), pnet.output(x).numpy(),
                               rtol=1e-5, atol=1e-6)
