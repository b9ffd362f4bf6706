"""The PyTorch port's regularization objects and remat against the JAX
package, on the CPU.

The IDropout objects, the constraints and the weight noise of
``nn/conf/regularization.py``: each random transform is fed the draws the
JAX package takes from its key (``bernoulli(k, p)`` is ``uniform(k) < p``;
Gaussian noise is the normal draw itself), since threefry and Philox
differ, and must then give the JAX answer. Constraints are held after
updater steps in a MultiLayerNetwork and a ComputationGraph against the
JAX package's training. ``remat=`` (``perf/fusion.remat_apply``): every
policy gives the loss and gradients of the run without it bitwise, dropout
on included (the explicit generator is replayed in the recompute), and
the JAX package's run without remat within the float tolerance.

Tolerances (float32): transforms rtol 1e-6 (elementwise, the same
algebra); trained parameters atol 2e-5, losses rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import layers as jlay
from deeplearning4j_tpu.nn.conf import normalization as jnorm
from deeplearning4j_tpu.nn.conf import regularization as jreg
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.conf.network import Builder as JB
from deeplearning4j_tpu.nn.conf.pooling import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.initializers import Distribution as JDist
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax, state_from_jax)
from deeplearning4j_tpu_torch.nn.conf.layers import (dropout_input, layer_from_dict,
                                                     noisy_params, weight_noise_keys)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves
from deeplearning4j_tpu_torch.perf.fusion import REMAT_POLICIES, remat_policy


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes in a process
    that has run XLA:CPU programs; the port's CPU path takes PyTorch's
    native convolutions in this file."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


X = np.random.default_rng(0).standard_normal((4, 5, 6)).astype(np.float32)

DROPOUTS = {
    "dropout": (lambda: jreg.Dropout(p=0.7), "uniform"),
    "alpha_dropout": (lambda: jreg.AlphaDropout(p=0.8), "uniform"),
    "gaussian_dropout": (lambda: jreg.GaussianDropout(rate=0.3), "normal"),
    "gaussian_noise": (lambda: jreg.GaussianNoise(stddev=0.2), "normal"),
}


@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_idropout_matches_jax_on_fed_draws(name):
    make, kind = DROPOUTS[name]
    jd = make()
    pd = layer_from_dict(jd.to_dict())
    key = jax.random.key(3)
    want = np.asarray(jd.apply(jnp.asarray(X), key, True))
    r = (jax.random.uniform(key, X.shape) if kind == "uniform"
         else jax.random.normal(key, X.shape, jnp.float32))
    np.testing.assert_allclose(pd.apply_drawn(_t(X), _t(r)).numpy(), want, rtol=1e-6, atol=1e-7)
    # off outside training and without a generator; drawn from one inside
    assert torch.equal(pd.apply(_t(X), torch.Generator().manual_seed(0), False), _t(X))
    assert torch.equal(pd.apply(_t(X), None, True), _t(X))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = dropout_input(_t(X), pd, True, g1)
    assert torch.equal(a, pd.apply_drawn(_t(X), pd.draw(X.shape, g2, "cpu", torch.float32)))
    assert not torch.equal(a, _t(X))


def test_float_dropout_is_the_dropout_object():
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    from deeplearning4j_tpu_torch.nn.conf.regularization import Dropout
    assert torch.equal(dropout_input(_t(X), 0.6, True, g1),
                       dropout_input(_t(X), Dropout(p=0.6), True, g2))


CONSTRAINTS = {
    "max_norm": lambda: jreg.MaxNormConstraint(max_norm=0.8),
    "min_max_norm": lambda: jreg.MinMaxNormConstraint(min_norm=0.5, max_norm=0.9, rate=0.7),
    "unit_norm": lambda: jreg.UnitNormConstraint(),
    "non_negative": lambda: jreg.NonNegativeConstraint(),
}


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_constraint_matches_jax(name):
    jc = CONSTRAINTS[name]()
    pc = layer_from_dict(jc.to_dict())
    rng = np.random.default_rng(1)
    for shape in ((7, 5), (3, 3, 4, 6), (5,)):
        w = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(pc.apply(_t(w)).numpy(), np.asarray(jc.apply(jnp.asarray(w))),
                                   rtol=1e-6, atol=1e-7)


def _mln(layers, it, updater, seed=3):
    b = JNNC.builder().seed(seed).updater(updater).list()
    for layer in layers:
        b = b.layer(layer)
    return b.set_input_type(it).build()


def _pair_mln(jconf):
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    net.set_params(params_from_jax(_host(jnet.params), "cpu"),
                   state_from_jax(_host(jnet.state), "cpu"))
    return jnet, net


def _close_params(got, want, atol=2e-5):
    for k in want:
        for name, v in (want[k].items() if isinstance(want[k], dict) else []):
            np.testing.assert_allclose(got[k][name].detach().numpy(), np.asarray(v), atol=atol,
                                       rtol=1e-5, err_msg=f"{k}/{name}")


def test_constraints_after_updates_match_jax_in_a_multilayer_network():
    jconf = _mln([jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu",
                                         constraints=(jreg.NonNegativeConstraint(
                                             apply_to_biases=True),)),
                  jlay.DenseLayer(n_out=6, activation="tanh",
                                  constraints=(jreg.MaxNormConstraint(max_norm=0.5),
                                               jreg.UnitNormConstraint(apply_to_biases=True))),
                  jlay.OutputLayer(n_out=3, constraints=(jreg.MinMaxNormConstraint(
                      min_norm=0.2, max_norm=0.4, rate=0.5),))],
                 JIT.convolutional(5, 5, 2), jupd.Sgd(learning_rate=0.1))
    jnet, net = _pair_mln(jconf)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 5, 5, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
        _close_params(dict(enumerate(net.params)), dict(enumerate(jnet.params)))
    assert float(net.params[0]["W"].min()) >= 0 and float(net.params[0]["b"].min()) >= 0
    norms = net.params[1]["W"].norm(dim=0)
    np.testing.assert_allclose(norms.numpy(), np.ones(6), rtol=1e-5)


def test_constraints_after_updates_match_jax_in_a_graph():
    parent = JB()
    parent.seed(4).updater(jupd.Adam(learning_rate=0.05))
    g = JGB(parent)
    g.add_inputs("in")
    g.add_layer("conv", jconv.ConvolutionLayer(n_out=3, kernel_size=(2, 2), activation="relu",
                                               constraints=(jreg.MaxNormConstraint(
                                                   max_norm=0.3),)), "in")
    g.add_layer("pool", JGP(pooling_type="avg"), "conv")
    g.add_layer("out", jlay.OutputLayer(n_out=2, constraints=(jreg.NonNegativeConstraint(),)),
                "pool")
    g.set_outputs("out")
    g.set_input_types(JIT.convolutional(4, 4, 2))
    jconf = g.build()
    jnet = JaxGraph(jconf).init()
    net = ComputationGraph(graph_conf_from_jax_json(jconf.to_json()), device="cpu").set_params(
        params_from_jax(_host(jnet.params), "cpu"), state_from_jax(_host(jnet.state), "cpu"))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 4, 4, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    _close_params(net.params, jnet.params)
    assert float(net.params["out"]["W"].min()) >= 0


NOISES = {
    "drop_connect": lambda: jreg.DropConnect(p=0.6, apply_to_bias=True),
    "weight_noise_normal": lambda: jreg.WeightNoise(stddev=0.1),
    "weight_noise_dist_mul": lambda: jreg.WeightNoise(
        dist=JDist(kind="uniform", lower=0.5, upper=1.5), additive=False),
}


@pytest.mark.parametrize("name", sorted(NOISES))
def test_weight_noise_matches_jax_on_fed_draws(name):
    jn = NOISES[name]()
    jl = jlay.DenseLayer(n_in=5, n_out=4, weight_noise=jn)
    pl = layer_from_dict(jl.to_dict())
    rng = np.random.default_rng(4)
    params = {"W": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    key = jax.random.key(7)
    want = jlay.noisy_params(jl, jax.tree_util.tree_map(jnp.asarray, params), key, True)
    keys = weight_noise_keys(pl, params)
    assert keys == (["W", "b"] if jn.apply_to_bias else ["W"])
    draws = {}
    for i, k in enumerate(keys):  # noisy_params folds 7919 + i into the key
        sub = jax.random.fold_in(key, 7919 + i)
        shape = params[k].shape
        if isinstance(jn, jreg.DropConnect):
            draws[k] = _t(jax.random.uniform(sub, shape))
        elif jn.dist is not None:
            draws[k] = _t(jn.dist.sample(sub, shape, jnp.float32))
        else:
            draws[k] = _t(jn.stddev * jax.random.normal(sub, shape, jnp.float32))
    got = noisy_params(pl, {k: _t(v) for k, v in params.items()}, None, True, draws=draws)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    # outside training, the parameters themselves
    tp = {k: _t(v) for k, v in params.items()}
    assert noisy_params(pl, tp, torch.Generator(), False) is tp


def test_noise_and_dropout_objects_train_reproducibly():
    """A network with dropout objects and weight noise trains from a seed,
    the same run twice bitwise, another seed otherwise; inference takes
    neither."""
    jconf = _mln([jlay.DenseLayer(n_out=8, activation="relu",
                                  dropout=jreg.AlphaDropout(p=0.9),
                                  weight_noise=jreg.DropConnect(p=0.8)),
                  jlay.DropoutLayer(dropout=jreg.GaussianDropout(rate=0.2)),
                  jlay.DenseLayer(n_out=8, activation="tanh",
                                  weight_noise=jreg.WeightNoise(stddev=0.05),
                                  dropout=jreg.GaussianNoise(stddev=0.1)),
                  jlay.OutputLayer(n_out=3)],
                 JIT.feed_forward(6), jupd.Adam(learning_rate=1e-2))
    conf = conf_from_jax_json(jconf.to_json())
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]

    def run(seed):
        net = MultiLayerNetwork(conf, device="cpu").init(seed=seed)
        out0 = net.output(x)
        scores = []
        for _ in range(15):
            net.fit(DataSet(x, y))
            scores.append(net.score())
        return net, out0, scores

    a, out_a, sa = run(1)
    b, _, sb = run(1)
    _, _, sc = run(2)
    assert sa == sb and sa != sc
    assert all(np.isfinite(sa)) and sa[-1] < sa[0]
    assert all(torch.equal(p, q) for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)))
    fresh = MultiLayerNetwork(conf, device="cpu").init(seed=1)
    assert torch.equal(fresh.output(x), out_a)  # no noise at inference


# ----------------------------------------------------------------- remat
def _remat_conf(remat, dropout):
    d = jreg.Dropout(p=0.8) if dropout else 0.0
    return _mln([jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="identity",
                                        has_bias=False, remat=remat, dropout=d),
                 jnorm.BatchNormalization(remat=remat),
                 jlay.ActivationLayer(activation="relu"),
                 jconv.SeparableConvolution2D(n_out=5, activation="tanh", remat=remat),
                 jlay.DenseLayer(n_out=6, activation="relu", remat=remat, dropout=d,
                                 weight_noise=jreg.DropConnect(p=0.9) if dropout else None),
                 jlay.OutputLayer(n_out=3)],
                JIT.convolutional(7, 7, 2), jupd.Sgd(learning_rate=0.1))


def _loss_grads(conf, params, state, x, y, seed=11):
    net = MultiLayerNetwork(conf, device="cpu").set_params(
        [{k: v.clone() for k, v in p.items()} for p in params],
        [{k: v.clone() for k, v in s.items()} for s in state])
    net._gen = torch.Generator().manual_seed(seed)
    loss, grads, new_state = net._loss_and_grads(_t(x), _t(y))
    return loss, grads, new_state, net._gen.get_state()


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_is_bitwise_the_run_without_it(policy, dropout):
    plain_conf = conf_from_jax_json(_remat_conf(None, dropout).to_json())
    remat_conf = conf_from_jax_json(_remat_conf(policy, dropout).to_json())
    assert remat_conf.layers[0].remat == policy
    net = MultiLayerNetwork(plain_conf, device="cpu").init()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 7, 7, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    want = _loss_grads(plain_conf, net.params, net.state, x, y)
    got = _loss_grads(remat_conf, net.params, net.state, x, y)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[2]), tree_leaves(want[2])))
    assert torch.equal(got[3], want[3])  # the generator ends where it would have


def test_remat_training_matches_jax_without_remat():
    jconf = _remat_conf(None, False)
    jnet, _ = _pair_mln(jconf)
    net = MultiLayerNetwork(conf_from_jax_json(_remat_conf("full", False).to_json()), "cpu")
    net.set_params(params_from_jax(_host(jnet.params), "cpu"),
                   state_from_jax(_host(jnet.state), "cpu"))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 7, 7, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    _close_params(dict(enumerate(net.params)), dict(enumerate(jnet.params)))


def test_remat_on_a_fused_graph_block_is_bitwise():
    """remat on the fused conv-BN-act blocks of a residual graph (the
    bn_act autograd function inside torch.utils.checkpoint)."""
    from deeplearning4j_tpu_torch.models import ResNet50
    conf = ResNet50(num_classes=3, input_shape=(16, 16, 3)).conf().fused()
    vertices = {n: ((dataclasses.replace(o, remat="full"), ins)
                    if type(o).__name__ == "FusedConvBNActivation" else (o, ins))
                for n, (o, ins) in conf.vertices.items()}
    rconf = dataclasses.replace(conf, vertices=vertices)
    g = ComputationGraph(conf, device="cpu").init()
    r = ComputationGraph(rconf, device="cpu").set_params(
        {n: {k: v.clone() for k, v in p.items()} for n, p in g.params.items()},
        {n: {k: v.clone() for k, v in s.items()} for n, s in g.state.items()})
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    for net in (g, r):
        net.fit(DataSet(x, y))
    assert g.score() == r.score()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g.params), tree_leaves(r.params)))


def test_unknown_remat_policy_raises():
    assert remat_policy("dots_saveable") == "recompute"
    assert remat_policy("everything_saveable") == "save"
    with pytest.raises(ValueError, match="Unknown remat policy"):
        remat_policy("sometimes")
    conf = conf_from_jax_json(_remat_conf(None, False).to_json())
    conf = dataclasses.replace(conf, layers=(dataclasses.replace(conf.layers[0],
                                                                 remat="sometimes"),)
                               + conf.layers[1:])
    # init validates the configuration first, as the JAX package's does
    with pytest.raises(ValueError, match="unknown-remat.*'sometimes'"):
        MultiLayerNetwork(conf, device="cpu").init()
    net = MultiLayerNetwork(conf, device="cpu").init(validate=False)
    with pytest.raises(ValueError, match="Unknown remat policy"):
        net.fit(DataSet(np.zeros((2, 7, 7, 2), np.float32), np.eye(3, dtype=np.float32)[[0, 1]]))


def test_new_layers_params_and_updater_state_cross_from_jax():
    """interop.params_from_jax / updater_state_from_jax carry the new
    layers' parameters (separable W_dw / W_pw, PReLU's alpha, the VAE's
    stacks, the RBM's vb, CenterLoss's cL) and their Adam moments: after
    one JAX step handed over, the next step agrees."""
    from deeplearning4j_tpu.nn.conf import pretrain as jpre
    from deeplearning4j_tpu.nn.conf import variational as jvae
    from deeplearning4j_tpu_torch.interop import updater_state_from_jax
    jconf = _mln([jconv.SeparableConvolution2D(n_out=4, depth_multiplier=2),
                  jlay.PReLULayer(shared_axes=(1, 2)),
                  jvae.VariationalAutoencoder(n_out=5, encoder_layer_sizes=(7,),
                                              decoder_layer_sizes=(6,)),
                  jpre.RBM(n_out=4),
                  jlay.CenterLossOutputLayer(n_out=3, alpha=0.5, lamda=0.1)],
                 JIT.convolutional(5, 5, 2), jupd.Adam(learning_rate=1e-2))
    jnet = JaxNet(jconf).init()
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 5, 5, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    jnet.fit(JaxDataSet(x, y))
    net = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    net.set_params(params_from_jax(_host(jnet.params), "cpu"),
                   state_from_jax(_host(jnet.state), "cpu"))
    keys = {k for p in net.params for k in p}
    assert {"W_dw", "W_pw", "alpha", "e0W", "d0W", "pzxMeanW", "pzxLogStd2b", "pxzW",
            "vb", "cL"} <= keys
    for i, st in enumerate(jnet.opt_state):
        adam = st[0]
        net.opt_state[i] = updater_state_from_jax(
            adam.count, {"mu": _host(adam.mu), "nu": _host(adam.nu)}, device="cpu")
    net.iteration = jnet.iteration
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    _close_params(dict(enumerate(net.params)), dict(enumerate(jnet.params)))
