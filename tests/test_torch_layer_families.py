"""The PyTorch port's remaining layer families against the JAX package, on
the CPU.

Every new layer class (PReLU, DropoutLayer, LRN, the separable, 1-D,
padding, cropping and upsampling layers, the fused separable and 1-D
blocks, the YOLO head, AutoEncoder, RBM, VariationalAutoencoder) is built
by the JAX package, carried to the port through its JSON, given the same
weights (JAX's init plus seeded noise) and the same numpy input; outputs
and the gradients of a fixed weighted sum against ``jax.grad``. Then the
YOLO loss and its gradients on the ``_yolo_fixture`` shapes of
tests/test_layer_families.py, CenterLoss over three training steps with
its center rule, the pretraining losses and one ``pretrain_layer`` step
with the random draws fed to the port (JAX's threefry draws reproduced
from its keys: parity never rests on a seed), the fused separable and
1-D chains trained against the JAX package's unfused chains, and every
new class's JSON both ways.

Tolerances (float32): layer outputs rtol 1e-5 / atol 1e-6, gradients and
losses rtol 1e-5 / atol 1e-5 (torch and XLA sum convolutions and
reductions in other orders); trained parameters after steps atol 2e-5;
bf16 losses rtol 2e-2.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import layers as jlay
from deeplearning4j_tpu.nn.conf import normalization as jnorm
from deeplearning4j_tpu.nn.conf import objdetect as jobj
from deeplearning4j_tpu.nn.conf import pretrain as jpre
from deeplearning4j_tpu.nn.conf import variational as jvae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, params_from_jax,
                                              state_from_jax)
from deeplearning4j_tpu_torch.nn.conf.convolutional import (FusedConv1DBNActivation,
                                                            FusedSeparableConvBNActivation)
from deeplearning4j_tpu_torch.nn.conf.layers import LAYER_REGISTRY, layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.normalization import LocalResponseNormalization
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer, get_predicted_objects
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

B = 2
CNN = (6, 6, 3)
RNN = (9, 4)
FF = 7


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes in a process
    that has run XLA:CPU programs; the port's CPU path takes PyTorch's
    native convolutions in this file."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _input(kind, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "cnn":
        return JIT.convolutional(*CNN), rng.standard_normal((B,) + CNN).astype(np.float32)
    if kind == "rnn":
        return JIT.recurrent(RNN[1], RNN[0]), rng.standard_normal((B,) + RNN).astype(np.float32)
    return JIT.feed_forward(FF), rng.random((B, FF)).astype(np.float32)


def _pair(jl, it, seed=0):
    """(JAX layer, port layer, params, state) with JAX's init plus noise."""
    params, state = jl.init(jax.random.key(seed), it)
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    state = {k: np.asarray(v) for k, v in state.items()}
    if "var" in state:  # running stats that matter
        state = {"mean": (0.1 * rng.standard_normal(state["mean"].shape)).astype(np.float32),
                 "var": (0.5 + rng.random(state["var"].shape)).astype(np.float32)}
    pl = layer_from_dict(jl.to_dict())
    assert type(pl).__name__ == type(jl).__name__
    return jl, pl, params, state


LAYERS = {
    "prelu_cnn": ("cnn", lambda: jlay.PReLULayer(shared_axes=(1, 2))),
    "prelu_ff": ("ff", lambda: jlay.PReLULayer()),
    "dropout_layer_eval": ("cnn", lambda: jlay.DropoutLayer(dropout=0.5)),
    "lrn": ("cnn", lambda: jnorm.LocalResponseNormalization(alpha=0.5)),
    "lrn_even": ("cnn", lambda: jnorm.LocalResponseNormalization(n=4, k=1.0, alpha=0.3)),
    "separable": ("cnn", lambda: jconv.SeparableConvolution2D(n_out=5, activation="tanh")),
    "separable_dm2_same_s2": ("cnn", lambda: jconv.SeparableConvolution2D(
        n_out=4, depth_multiplier=2, convolution_mode="same", stride=(2, 2))),
    "upsampling2d": ("cnn", lambda: jconv.Upsampling2D(size=(2, 3))),
    "zero_padding": ("cnn", lambda: jconv.ZeroPaddingLayer(padding=(1, 2, 0, 1))),
    "zero_padding_sym": ("cnn", lambda: jconv.ZeroPaddingLayer(padding=(1, 1))),
    "conv1d": ("rnn", lambda: jconv.Convolution1DLayer(n_out=5, padding=1, activation="relu")),
    "conv1d_same_s2_d2": ("rnn", lambda: jconv.Convolution1DLayer(
        n_out=3, kernel_size=3, stride=2, dilation=2, convolution_mode="same")),
    "subsampling1d_max": ("rnn", lambda: jconv.Subsampling1DLayer(kernel_size=3, stride=2)),
    "subsampling1d_avg": ("rnn", lambda: jconv.Subsampling1DLayer(pooling_type="avg",
                                                                  padding=1)),
    "subsampling1d_pnorm_same": ("rnn", lambda: jconv.Subsampling1DLayer(
        pooling_type="pnorm", pnorm=3, convolution_mode="same")),
    "upsampling1d": ("rnn", lambda: jconv.Upsampling1D(size=3)),
    "cropping2d": ("cnn", lambda: jconv.Cropping2D(cropping=(1, 0, 1, 2))),
    "cropping1d": ("rnn", lambda: jconv.Cropping1D(cropping=(1, 2))),
    "zero_padding1d": ("rnn", lambda: jconv.ZeroPadding1DLayer(padding=(2, 1))),
    "fused_separable_eval": ("cnn", lambda: jconv.FusedSeparableConvBNActivation(
        n_out=4, depth_multiplier=2, activation="leakyrelu")),
    "fused_conv1d_eval": ("rnn", lambda: jconv.FusedConv1DBNActivation(n_out=5)),
    "autoencoder": ("ff", lambda: jpre.AutoEncoder(n_out=4)),
    "rbm": ("ff", lambda: jpre.RBM(n_out=4)),
    "vae": ("ff", lambda: jvae.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(6,),
                                                      decoder_layer_sizes=(5, 4))),
    "yolo_activations": ("cnn_yolo", lambda: jobj.Yolo2OutputLayer(
        boxes=((1.0, 1.5), (2.0, 0.5)))),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name):
    kind, make = LAYERS[name]
    if kind == "cnn_yolo":  # B * (5 + C) channels, C = 3
        it = JIT.convolutional(3, 3, 16)
        x = np.random.default_rng(1).standard_normal((B, 3, 3, 16)).astype(np.float32)
    else:
        it, x = _input(kind)
    jl, pl, params, state = _pair(make(), it, seed=len(name))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out_j = jax.jit(lambda p, xx: jl.apply(p, state, xx)[0])(jp, jnp.asarray(x))
    w = np.random.default_rng(2).standard_normal(np.shape(out_j)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, state, xx)[0] * w)

    gp_j, gx_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))

    pp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    xx = _t(x).requires_grad_(True)
    out_p, _ = pl.apply(pp, {k: _t(v) for k, v in state.items()}, xx)
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(torch.sum(out_p * _t(w)), [xx] + list(pp.values()),
                                allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-5)
    for (k, _), g in zip(pp.items(), grads[1:]):
        want = np.asarray(gp_j[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
    if kind != "cnn_yolo":
        assert pl.output_type(it).to_dict() == jl.output_type(it).to_dict()
    assert pl.regularizable() == jl.regularizable()


def test_separable_depth_multiplier_two_channel_order():
    """Depthwise output channel c * 2 + m reads input channel c only (the
    JAX package's HWIO (kh, kw, 1, C * 2) layout, XLA's group order)."""
    jl = jconv.SeparableConvolution2D(n_out=6, depth_multiplier=2, kernel_size=(1, 1),
                                      has_bias=False)
    pl = layer_from_dict(jl.to_dict())
    c = 3
    w_dw = np.zeros((1, 1, 1, 2 * c), np.float32)
    for ch in range(c):
        w_dw[0, 0, 0, 2 * ch] = 1.0 + ch        # m = 0: scale by 1 + c
        w_dw[0, 0, 0, 2 * ch + 1] = -10.0 * (1 + ch)  # m = 1
    w_pw = np.eye(2 * c, 6, dtype=np.float32)[None, None]  # pass the depthwise out on
    x = np.random.default_rng(3).standard_normal((1, 2, 2, c)).astype(np.float32)
    got, _ = pl.apply({"W_dw": _t(w_dw), "W_pw": _t(w_pw)}, {}, _t(x))
    want, _ = jl.apply({"W_dw": jnp.asarray(w_dw), "W_pw": jnp.asarray(w_pw)}, {},
                       jnp.asarray(x))
    for ch in range(c):
        np.testing.assert_allclose(got[..., 2 * ch].numpy(), x[..., ch] * (1 + ch), rtol=1e-6)
        np.testing.assert_allclose(got[..., 2 * ch + 1].numpy(), -10 * (1 + ch) * x[..., ch],
                                   rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_lrn_window_semantics_and_not_torch_lrn():
    """n = 2 sums 3 channels (the reference's halfN loop), alpha is not
    divided by the window; F.local_response_norm divides it, so it gives
    another answer."""
    x = np.zeros((1, 1, 1, 5), np.float32)
    x[0, 0, 0, 2] = 2.0
    layer = LocalResponseNormalization(n=2, k=1.0, alpha=1.0, beta=1.0)
    out, _ = layer.apply({}, {}, _t(x))
    np.testing.assert_allclose(out[0, 0, 0].numpy(), [0, 0, 2 / 5, 0, 0], rtol=1e-6)
    even, _ = LocalResponseNormalization(n=4).apply({}, {}, _t(np.ones((2, 3, 3, 8), np.float32)))
    assert even.shape == (2, 3, 3, 8)
    xr = np.random.default_rng(0).random((2, 4, 4, 8)).astype(np.float32)
    lrn = LocalResponseNormalization(n=5, k=2.0, alpha=0.5, beta=0.75)
    ours = lrn.apply({}, {}, _t(xr))[0]
    theirs = F.local_response_norm(_t(xr).permute(0, 3, 1, 2), 5, alpha=0.5, beta=0.75,
                                   k=2.0).permute(0, 2, 3, 1)
    assert float((ours - theirs).abs().max()) > 1e-2
    # torch's with alpha scaled by the window is ours
    scaled = F.local_response_norm(_t(xr).permute(0, 3, 1, 2), 5, alpha=0.5 * 5, beta=0.75,
                                   k=2.0).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), scaled.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- YOLO
def _yolo_fixture(mb=2, H=4, W=4, B=2, C=3, seed=0):
    """tests/test_layer_families.py's fixture: one box an example."""
    rng = np.random.default_rng(seed)
    preout = rng.standard_normal((mb, H, W, B * (5 + C))).astype(np.float32)
    labels = np.zeros((mb, H, W, 4 + C), np.float32)
    for e in range(mb):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        cls = rng.integers(0, C)
        w, h = rng.uniform(0.5, 2.0, 2)
        x1, y1 = cx + 0.5 - w / 2, cy + 0.5 - h / 2
        labels[e, cy, cx, 0:4] = [x1, y1, x1 + w, y1 + h]
        labels[e, cy, cx, 4 + cls] = 1.0
    return preout, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yolo_loss_and_gradients_match_jax(seed):
    jl = jobj.Yolo2OutputLayer(boxes=((1.0, 1.0), (2.0, 1.5)))
    pl = layer_from_dict(jl.to_dict())
    preout, labels = _yolo_fixture(seed=seed)
    score = jax.jit(jax.value_and_grad(lambda p, lab: jl.compute_score(lab, p)))
    for lab in (labels, np.zeros_like(labels)):
        want, g_want = score(jnp.asarray(preout), jnp.asarray(lab))
        p = _t(preout).requires_grad_(True)
        got = pl.compute_score(_t(lab), p)
        (g_got,) = torch.autograd.grad(got, [p])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pl.compute_score_array(_t(lab), _t(preout)).numpy(),
                                   np.asarray(jax.jit(jl.compute_score_array)(
                                       jnp.asarray(lab), jnp.asarray(preout))),
                                   rtol=1e-5, atol=1e-6)
    # the decoded detections agree
    act = np.asarray(jax.jit(jl.output_activations)(jnp.asarray(preout)))
    ours = get_predicted_objects(pl.output_activations(_t(preout)), 2, threshold=0.3)
    theirs = jobj.get_predicted_objects(act, 2, threshold=0.3)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a.example, a.predicted_class) == (b.example, b.predicted_class)
        np.testing.assert_allclose([a.center_x, a.center_y, a.width, a.height, a.confidence],
                                   [b.center_x, b.center_y, b.width, b.height, b.confidence],
                                   rtol=1e-5)


def test_yolo_responsible_box_tie_takes_the_lower_index():
    """Two identical priors give identical IoUs: the first box is
    responsible, as jnp.argmax picks."""
    jl = jobj.Yolo2OutputLayer(boxes=((1.0, 1.0), (1.0, 1.0)))
    pl = Yolo2OutputLayer(boxes=((1.0, 1.0), (1.0, 1.0)))
    preout, labels = _yolo_fixture(B=2, seed=4)
    preout[..., 8:16] = preout[..., 0:8]  # box 1 predicts what box 0 does
    p = _t(preout).requires_grad_(True)
    (g,) = torch.autograd.grad(pl.compute_score(_t(labels), p), [p])
    g_j = jax.jit(jax.grad(lambda q: jl.compute_score(jnp.asarray(labels), q)))(
        jnp.asarray(preout))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)
    obj = labels[..., 4:].sum(-1) > 0
    # in object cells the class gradient lands on box 0 only
    assert np.abs(g.numpy()[obj][:, 5:8]).sum() > 0
    assert np.abs(g.numpy()[obj][:, 13:16]).sum() == 0


def test_yolo_gradient_at_an_underflowed_width_is_nan_as_in_jax():
    """A width or height logit below float32 exp's range makes the
    predicted size 0, and sqrt's derivative there times the zero mask of a
    box that is not responsible is NaN, in both packages at the same
    entries; every other entry agrees (rtol 1e-5, atol 1e-6)."""
    jl = jobj.Yolo2OutputLayer(boxes=((1.0, 1.0), (2.0, 1.5)))
    pl = layer_from_dict(jl.to_dict())
    preout, labels = _yolo_fixture(seed=0)
    preout[0, 0, 0, 8 + 2] = preout[1, 1, 1, 3] = -110.0
    p = _t(preout).requires_grad_(True)
    (g,) = torch.autograd.grad(pl.compute_score(_t(labels), p), [p])
    g_j = np.asarray(jax.jit(jax.grad(lambda q: jl.compute_score(jnp.asarray(labels), q)))(
        jnp.asarray(preout)))
    bad = ~np.isfinite(g.numpy())
    assert np.argwhere(bad).tolist() == [[0, 0, 0, 10], [1, 1, 1, 3]]
    np.testing.assert_array_equal(bad, ~np.isfinite(g_j))
    np.testing.assert_allclose(g.numpy()[~bad], g_j[~bad], rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- networks
def _jax_mln(layers, it, updater, dtype="float32", seed=3):
    b = JNNC.builder().seed(seed).updater(updater).dtype(dtype).list()
    for layer in layers:
        b = b.layer(layer)
    return b.set_input_type(it).build()


def _pair_nets(jconf, seed=0):
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    net.set_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), "cpu"),
                   state_from_jax(jax.tree_util.tree_map(np.asarray, jnet.state), "cpu"))
    return jnet, net


def _assert_params_close(net, jnet, atol):
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(jp[k]), atol=atol,
                                       rtol=1e-5, err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("updater", ["sgd", "adam", "sgd_gradient_check"])
def test_center_loss_three_steps_follow_the_center_rule(updater):
    upd = (jupd.Adam(learning_rate=1e-2) if updater == "adam"
           else jupd.Sgd(learning_rate=0.1))
    jconf = _jax_mln([jlay.DenseLayer(n_out=6, activation="tanh"),
                      jlay.CenterLossOutputLayer(n_out=3, alpha=0.5, lamda=0.1,
                                                 gradient_check=updater.endswith("check"))],
                     JIT.feed_forward(FF), upd)
    jnet, net = _pair_nets(jconf)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, FF)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
        _assert_params_close(net, jnet, atol=2e-5)
    assert float(net.params[1]["cL"].abs().max()) > 0
    if updater == "sgd":
        # Sgd(lr): the center step is -lr * alpha * sum over the class of
        # (c_y - f) / (count_y + 1), from the pseudo-term's gradient alone
        feats = np.tanh(x @ net.params[0]["W"].detach().numpy() + net.params[0]["b"].detach().numpy())
        c0 = net.params[1]["cL"].detach().clone()
        net.fit(DataSet(x, y))
        counts = y.sum(0)
        want = c0.numpy() - 0.1 * 0.5 * ((y.T @ (c0.numpy()[y.argmax(1)] - feats))
                                          / (counts + 1)[:, None])
        np.testing.assert_allclose(net.params[1]["cL"].detach().numpy(), want, atol=1e-5)


def test_center_loss_and_yolo_losses_under_bf16_compute():
    """The pytree pre-outputs (CenterLoss's dict, YOLO's grid) reach the
    loss in float32 under bf16 compute with float32 masters."""
    jconf = _jax_mln([jlay.DenseLayer(n_out=6, activation="tanh"),
                      jlay.CenterLossOutputLayer(n_out=3, alpha=0.5, lamda=0.1)],
                     JIT.feed_forward(FF), jupd.Sgd(learning_rate=0.1), dtype="bfloat16")
    jnet, net = _pair_nets(jconf)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, FF)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    np.testing.assert_allclose(net.score(), jnet.score(), rtol=2e-2)
    assert all(p.dtype == torch.float32 for layer in net.params for p in layer.values())
    preout, labels = _yolo_fixture(mb=2, H=3, W=3)
    yconf = _jax_mln([jconv.ConvolutionLayer(n_out=16, kernel_size=(1, 1)),
                      jobj.Yolo2OutputLayer(boxes=((1.0, 1.0), (2.0, 1.5)))],
                     JIT.convolutional(3, 3, 16), jupd.Sgd(learning_rate=0.01),
                     dtype="bfloat16")
    jy, py = _pair_nets(yconf)
    jy.fit(JaxDataSet(preout, labels))
    py.fit(DataSet(preout, labels))
    np.testing.assert_allclose(py.score(), jy.score(), rtol=2e-2)


# ------------------------------------------------------------ pretraining
def _jax_uniform_draws(key, shapes):
    return [np.asarray(jax.random.uniform(k, s)) for k, s in zip(key, shapes)]


def test_autoencoder_pretrain_loss_with_fed_corruption():
    for loss, sparsity in (("mse", 0.0), ("xent", 0.05)):
        jl, pl, params, _ = _pair(jpre.AutoEncoder(n_out=4, loss=loss, sparsity=sparsity,
                                                   corruption_level=0.3), JIT.feed_forward(FF))
        _, x = _input("ff")
        key = jax.random.key(9)
        # the JAX loss splits its key once and draws bernoulli(k, 0.7) = uniform(k) < 0.7
        _, k = jax.random.split(key)
        u = np.asarray(jax.random.uniform(k, x.shape))
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        want, gw = jax.jit(jax.value_and_grad(
            lambda p: jl.pretrain_loss(p, {}, jnp.asarray(x), key)))(jp)
        pp = {k_: _t(v).requires_grad_(True) for k_, v in params.items()}
        got = pl.pretrain_loss(pp, {}, _t(x), draws=_t(u))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for k_, g in zip(pp, torch.autograd.grad(got, list(pp.values()))):
            np.testing.assert_allclose(g.numpy(), np.asarray(gw[k_]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_rbm_cd_k_loss_with_fed_gibbs_draws(visible):
    jl, pl, params, _ = _pair(jpre.RBM(n_out=4, k=2, visible_unit=visible, sparsity=0.1),
                              JIT.feed_forward(FF))
    _, x = _input("ff")
    key = jax.random.key(11)
    draws = []
    for sub in jax.random.split(key, 2):  # gibbs_chain: split(rng, k), then kh, kv a step
        kh, kv = jax.random.split(sub)
        u_h = jax.random.uniform(kh, (B, 4))
        r_v = (jax.random.normal(kv, (B, FF)) if visible == "gaussian"
               else jax.random.uniform(kv, (B, FF)))
        draws.append((_t(np.asarray(u_h)), _t(np.asarray(r_v))))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, gw = jax.jit(jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, {}, jnp.asarray(x), key)))(jp)
    pp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    got = pl.pretrain_loss(pp, {}, _t(x), draws=draws)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    for k, g in zip(pp, torch.autograd.grad(got, list(pp.values()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw[k]), rtol=1e-5, atol=1e-5)
    re_j = jax.jit(lambda p: jl.reconstruction_error(p, jnp.asarray(x), key))(jp)
    kh, kv = jax.random.split(jax.random.split(key, 1)[0])
    r_v = (jax.random.normal(kv, (B, FF)) if visible == "gaussian"
           else jax.random.uniform(kv, (B, FF)))
    re_p = pl.reconstruction_error({k: _t(v) for k, v in params.items()}, _t(x),
                                   draws=[(_t(np.asarray(jax.random.uniform(kh, (B, 4)))),
                                           _t(np.asarray(r_v)))])
    np.testing.assert_allclose(float(re_p), float(re_j), rtol=1e-5)


def _vae_eps(key, n, shape):
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(_t(np.array(jax.random.normal(k, shape))))
    return out


@pytest.mark.parametrize("recon", ["bernoulli", "gaussian"])
def test_vae_pretrain_loss_reconstruction_probability_and_generation(recon):
    jl, pl, params, _ = _pair(jvae.VariationalAutoencoder(
        n_out=3, encoder_layer_sizes=(6,), decoder_layer_sizes=(5,), reconstruction=recon,
        num_samples=2, pzx_activation="tanh"), JIT.feed_forward(FF))
    _, x = _input("ff")
    key = jax.random.key(13)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, gw = jax.jit(jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, {}, jnp.asarray(x), key)))(jp)
    pp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    got = pl.pretrain_loss(pp, {}, _t(x), draws=_vae_eps(key, 2, (B, 3)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k, g in zip(pp, torch.autograd.grad(got, list(pp.values()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    tp = {k: _t(v) for k, v in params.items()}
    rp_j = jax.jit(lambda p: jl.reconstruction_probability(p, jnp.asarray(x), key,
                                                           num_samples=3))(jp)
    rp_p = pl.reconstruction_probability(tp, _t(x), draws=_vae_eps(key, 3, (B, 3)))
    np.testing.assert_allclose(rp_p.numpy(), np.asarray(rp_j), rtol=1e-5, atol=1e-5)
    z = np.random.default_rng(4).standard_normal((B, 3)).astype(np.float32)
    np.testing.assert_allclose(pl.generate_at_mean_given_z(tp, _t(z)).numpy(),
                               np.asarray(jax.jit(jl.generate_at_mean_given_z)(
                                   jp, jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)


def test_pretrain_layer_step_matches_jax_and_pretrain_runs():
    """One pretrain_layer step of a VAE over a frozen dense layer, the
    draws JAX's step takes fed to the port, with Adam; then pretrain()
    over an AutoEncoder, an RBM and the VAE."""
    jconf = _jax_mln([jlay.DenseLayer(n_out=6, activation="sigmoid"),
                      jvae.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(5,),
                                                  decoder_layer_sizes=(5,)),
                      jlay.OutputLayer(n_out=2)],
                     JIT.feed_forward(FF), jupd.Adam(learning_rate=1e-2))
    jnet, net = _pair_nets(jconf)
    _, x = _input("ff")
    # JAX's pretrain_layer: self._rng, k = split(self._rng); the VAE then
    # splits k once a sample
    _, k = jax.random.split(jnet._rng)
    eps = _vae_eps(k, 1, (B, 3))
    jnet.pretrain_layer(1, [x])
    net.pretrain_layer(1, [DataSet(x, np.zeros((B, 2), np.float32))], draws=[eps])
    np.testing.assert_allclose(net.score(), float(jnet._score), rtol=1e-5)
    _assert_params_close(net, jnet, atol=2e-6)
    assert net.iteration == 1

    conf = _jax_mln([jpre.AutoEncoder(n_out=6), jpre.RBM(n_out=5),
                     jvae.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(4,),
                                                 decoder_layer_sizes=(4,)),
                     jlay.OutputLayer(n_out=2)], JIT.feed_forward(FF), jupd.Adam(1e-2))
    pnet = MultiLayerNetwork(conf_from_jax_json(conf.to_json()), device="cpu").init()
    before = [{k: v.clone() for k, v in p.items()} for p in pnet.params]
    pnet.pretrain([x, x], num_epochs=2)
    assert pnet.iteration == 3 * 4 and np.isfinite(pnet.score())
    for i in range(3):
        assert any(not torch.equal(before[i][k], pnet.params[i][k]) for k in before[i])
    assert all(torch.equal(before[3][k], pnet.params[3][k]) for k in before[3])
    with pytest.raises(ValueError, match="not pretrainable"):
        pnet.pretrain_layer(3, [x])


# ----------------------------------------------------------- fused chains
CHAINS = {
    "separable": (lambda: jconv.SeparableConvolution2D(n_out=4, depth_multiplier=2,
                                                       convolution_mode="same"),
                  "cnn", FusedSeparableConvBNActivation),
    "separable_strided": (lambda: jconv.SeparableConvolution2D(n_out=5, stride=(2, 2)),
                          "cnn", FusedSeparableConvBNActivation),
    "conv1d": (lambda: jconv.Convolution1DLayer(n_out=6, has_bias=False), "rnn",
               FusedConv1DBNActivation),
    "conv1d_same_dilated": (lambda: jconv.Convolution1DLayer(n_out=4, dilation=2,
                                                             convolution_mode="same"),
                            "rnn", FusedConv1DBNActivation),
}


@pytest.mark.parametrize("act", ["relu", "leakyrelu", None])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fused_chain_trains_like_the_jax_unfused_chain(chain, act):
    """head -> BN -> activation fused by the port's fuse (the same JSON as
    the JAX package's fuse) trains two Sgd steps like the JAX package's
    unfused chain; eval mode after them as well."""
    from deeplearning4j_tpu.perf.fusion import fuse as jax_fuse
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    make, kind, fused_cls = CHAINS[chain]
    it, x = _input(kind, seed=7)
    tail = [jlay.ActivationLayer(activation=act)] if act else []
    if kind == "cnn":
        head = jlay.OutputLayer(n_out=3)
    else:
        from deeplearning4j_tpu.nn.conf.recurrent import RnnOutputLayer
        head = RnnOutputLayer(n_out=3)
    layers = [make(), jnorm.BatchNormalization(), *tail, head]
    jconf = _jax_mln(layers, it, jupd.Sgd(learning_rate=0.05))
    jnet, _ = _pair_nets(jconf)
    fconf = conf_from_jax_json(jconf.to_json()).fused()
    assert json.loads(fconf.to_json()) == json.loads(jax_fuse(jconf).to_json())
    assert isinstance(fconf.layers[0], fused_cls) and len(fconf.layers) == 2
    net = MultiLayerNetwork(fconf, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jnet.params)
    fused_p = dict(jp[0], gamma=jp[1]["gamma"], beta=jp[1]["beta"])
    net.set_params(params_from_jax([fused_p, jp[-1]], "cpu"),
                   state_from_jax([jax.tree_util.tree_map(np.asarray, jnet.state[1]), {}], "cpu"))
    rows = np.random.default_rng(1).integers(0, 3, (B,) if kind == "cnn" else
                                             (B, jconf.layer_input_types()[-1].timeseries_length))
    y = np.eye(3, dtype=np.float32)[rows]
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    jp = jnet.params
    for k in net.params[0]:
        src = jp[1][k] if k in ("gamma", "beta") else jp[0][k]
        np.testing.assert_allclose(net.params[0][k].numpy(), np.asarray(src), atol=2e-5,
                                   rtol=1e-5, err_msg=k)
    for k in ("mean", "var"):
        np.testing.assert_allclose(net.state[0][k].numpy(), np.asarray(jnet.state[1][k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- JSON
def _new_class_examples():
    """One configured instance of every class this slice registers."""
    from deeplearning4j_tpu.nn.conf import regularization as jreg
    from deeplearning4j_tpu.nn.initializers import Distribution as JDist
    return [jlay.PReLULayer(shared_axes=(1, 2)), jlay.DropoutLayer(dropout=0.7),
            jlay.CenterLossOutputLayer(n_out=3, alpha=0.1, lamda=0.01, gradient_check=True),
            jlay.LossLayer(loss="mse", activation="tanh"),
            jnorm.LocalResponseNormalization(n=3, beta=0.5),
            jobj.Yolo2OutputLayer(boxes=((1.0, 2.0), (3.0, 4.0)), lambda_coord=4.0),
            jpre.AutoEncoder(n_out=3, corruption_level=0.2, loss="xent"),
            jpre.RBM(n_out=3, k=2, visible_unit="gaussian"),
            jvae.VariationalAutoencoder(n_out=2, encoder_layer_sizes=(5, 4),
                                        reconstruction="gaussian"),
            jconv.SeparableConvolution2D(n_out=3, depth_multiplier=2),
            jconv.Upsampling2D(size=(2, 3)), jconv.ZeroPaddingLayer(padding=(1, 2, 3, 4)),
            jconv.Convolution1DLayer(n_out=3, dilation=2), jconv.Subsampling1DLayer(
                pooling_type="pnorm"), jconv.Upsampling1D(size=3),
            jconv.Cropping2D(cropping=(1, 1)), jconv.Cropping1D(cropping=(1, 0)),
            jconv.ZeroPadding1DLayer(padding=(0, 2)),
            jconv.FusedSeparableConvBNActivation(n_out=3, activation="leakyrelu"),
            jconv.FusedConv1DBNActivation(n_out=3, eps=1e-3),
            jreg.Dropout(p=0.8), jreg.AlphaDropout(p=0.9), jreg.GaussianDropout(rate=0.2),
            jreg.GaussianNoise(stddev=0.3), jreg.MaxNormConstraint(max_norm=1.5),
            jreg.MinMaxNormConstraint(min_norm=0.1, max_norm=0.9, rate=0.5,
                                      apply_to_biases=True),
            jreg.UnitNormConstraint(), jreg.NonNegativeConstraint(apply_to_weights=False),
            jreg.DropConnect(p=0.6, apply_to_bias=True),
            jreg.WeightNoise(dist=JDist(kind="uniform", lower=-0.1, upper=0.1),
                             additive=False),
            jlay.DenseLayer(n_out=3, dropout=jreg.GaussianNoise(stddev=0.2),
                            constraints=(jreg.MaxNormConstraint(max_norm=1.0),
                                         jreg.NonNegativeConstraint()),
                            weight_noise=jreg.DropConnect(p=0.9))]


@pytest.mark.parametrize("i", range(31))
def test_new_class_json_round_trips_both_ways(i):
    from deeplearning4j_tpu.nn.conf.layers import layer_from_dict as jax_from_dict
    jl = _new_class_examples()[i]
    d = json.loads(json.dumps(jl.to_dict()))
    pl = layer_from_dict(d)
    assert type(pl).__name__ == type(jl).__name__ and type(pl).__name__ in LAYER_REGISTRY
    assert json.loads(json.dumps(pl.to_dict())) == d
    assert json.loads(json.dumps(jax_from_dict(json.loads(json.dumps(pl.to_dict())))
                                 .to_dict())) == d


def test_every_jax_layer_class_is_registered():
    import deeplearning4j_tpu.nn.conf.layers as jlayers
    import deeplearning4j_tpu.quant  # noqa: F401  (the quantized layers)
    import deeplearning4j_tpu_torch.quant  # noqa: F401
    assert sorted(jlayers.LAYER_REGISTRY) == sorted(LAYER_REGISTRY)
    assert len(_new_class_examples()) == 31


def test_separable_fuse_json_matches_jax_in_a_graph():
    """A separable and a 1-D head never take the residual add in a graph."""
    from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex as JEW
    from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JGB
    from deeplearning4j_tpu.nn.conf.network import Builder as JB
    from deeplearning4j_tpu.perf.fusion import fuse as jax_fuse
    from deeplearning4j_tpu_torch.interop import graph_conf_from_jax_json
    g = JGB(JB())
    g.add_inputs("in")
    g.add_layer("sep", jconv.SeparableConvolution2D(n_out=3, convolution_mode="same"), "in")
    g.add_layer("bn", jnorm.BatchNormalization(), "sep")
    g.add_vertex("add", JEW(op="add"), "bn", "in")
    g.add_layer("act", jlay.ActivationLayer(activation="relu"), "add")
    g.add_layer("sep2", jconv.SeparableConvolution2D(n_out=3, convolution_mode="same"), "act")
    g.add_layer("bn2", jnorm.BatchNormalization(), "sep2")
    g.add_layer("act2", jlay.ActivationLayer(activation="relu"), "bn2")
    g.add_layer("pool", __import__("deeplearning4j_tpu.nn.conf.pooling",
                                   fromlist=["x"]).GlobalPoolingLayer(), "act2")
    g.add_layer("out", jlay.OutputLayer(n_out=2), "pool")
    g.set_outputs("out")
    g.set_input_types(JIT.convolutional(4, 4, 3))
    jconf = g.build()
    fused = graph_conf_from_jax_json(jconf.to_json()).fused()
    assert json.loads(fused.to_json()) == json.loads(jax_fuse(jconf).to_json())
    kinds = {n: type(o).__name__ for n, (o, _) in fused.vertices.items()}
    assert kinds["act2"] == "FusedSeparableConvBNActivation"
    assert kinds["bn"] == "FusedSeparableConvBNActivation"  # no residual: BN keeps it



@pytest.fixture
def cuda_device():
    """The card under the port's device rule (float32 convolutions without
    TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bn_act kernels have no CPU mode")
    from deeplearning4j_tpu_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fused_chain_launches_the_kernels_on_card(cuda_device, chain):
    """The fused separable and 1-D blocks run bn_act_fwd / bn_act_bwd on
    the card, once each a training step, and agree with the CPU's plain
    versions (loss rtol 1e-4, gradients atol 1e-4)."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    make, kind, fused_cls = CHAINS[chain]
    it, x = _input(kind, seed=7)
    jl = {"separable": jconv.FusedSeparableConvBNActivation,
          "conv1d": jconv.FusedConv1DBNActivation}[chain.split("_")[0]]
    head = make()
    fields = {k: getattr(head, k) for k in ("n_out", "kernel_size", "stride", "padding",
                                            "convolution_mode")}
    fields.update({k: getattr(head, k) for k in ("depth_multiplier", "dilation")
                   if hasattr(head, k)})
    jfused = jl(activation="leakyrelu", **fields)
    _, pl, params, state = _pair(jfused, it, seed=3)
    assert isinstance(pl, fused_cls)
    w = np.random.default_rng(2).standard_normal(
        tuple(pl.apply({k: _t(v) for k, v in params.items()},
                       {k: _t(v) for k, v in state.items()}, _t(x), train=True)[0].shape))
    grads = {}
    for dev in ("cpu", cuda_device):
        pp = {k: _t(v).to(dev).requires_grad_(True) for k, v in params.items()}
        f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
        out, _ = pl.apply(pp, {k: _t(v).to(dev) for k, v in state.items()}, _t(x).to(dev),
                          train=True)
        loss = torch.sum(out * _t(w).float().to(dev))
        loss.backward()
        if dev != "cpu":
            assert (bn_act.fwd_launches - f0, bn_act.bwd_launches - b0) == (1, 1)
        grads[str(dev)] = (loss.item(), {k: v.grad.cpu() for k, v in pp.items()})
    (lc, gc), (lg, gg) = grads["cpu"], grads[str(cuda_device)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in gc:
        np.testing.assert_allclose(gg[k].numpy(), gc[k].numpy(), atol=1e-4, rtol=1e-4)
