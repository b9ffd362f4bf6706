"""The PyTorch port's zoo, BN folding, and the folded and zipped networks
against the JAX package, on the CPU.

- Every zoo model's full-size configuration JSON equals the JAX package's,
  and so does its parameter count (counted from shapes alone: the port's
  init on the ``meta`` device, ``jax.eval_shape`` there); ``models``
  exports the same names.
- ``fuse`` on the full-size TinyYOLO detection configuration, FaceNetNN4Small2
  and InceptionResNetV1 gives the JAX package's fused JSON: 7, 37 and 127
  FusedConvBNActivation blocks, no BatchNormalization left in the two
  FaceNet graphs.
- ``fold_bn`` on tests/test_fusion.py's list of zoo models at their small
  shapes: the folded network's output against the unfolded one, and the
  unfolded one against the JAX package's unfolded network on the same
  weights and randomised running stats; ``ZooModel.init(fold_bn=True)``;
  a fused network and a transfer-learned one fold too;
  ``quantize(fold=True)`` and ``ParallelInference(fold_bn=True)`` on a BN
  network against the JAX package's.
- A JAX-written zip of a TinyYOLO detection network and of a
  FaceNetNN4Small2 (after one Adam or Nesterovs step, so updater state and
  CenterLoss centers cross too) restored by the port, and the port's zip
  restored by the JAX package, bitwise; TinyYOLO trains two steps like the
  JAX package; ``init_pretrained`` reads a local zip.

Tolerances: forwards rtol 2e-4 / atol 2e-5 (tests/test_fusion.py's own for
folding: the fold reassociates the BN scale into the conv sum), the port
against JAX rtol 1e-4 / atol 1e-5 (torch and XLA sum convolutions in other
orders through up to 60 layers), losses rtol 1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.models as jm
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import layers as jlay
from deeplearning4j_tpu.nn.conf import normalization as jnorm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.perf.fusion import fuse as jax_fuse
from deeplearning4j_tpu.quant import calibrate as jax_calibrate
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.utils import serialization as jser

import deeplearning4j_tpu_torch.models as pm
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import conf_from_jax_json
from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.perf.fusion import fold_bn
from deeplearning4j_tpu_torch.quant import CalibrationRecord, calibrate, quantize
from deeplearning4j_tpu_torch.utils import serialization as pser

VOC_PRIORS = [(1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11), (16.62, 10.52)]
ZOO = ["AlexNet", "Darknet19", "FaceNetNN4Small2", "GoogLeNet", "InceptionResNetV1", "LeNet",
       "ResNet50", "SimpleCNN", "TextGenerationLSTM", "TinyYOLO", "VGG16", "VGG19"]


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes in a process
    that has run XLA:CPU programs; the port's CPU path takes PyTorch's
    native convolutions in this file."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _confs(name):
    if name == "TinyYOLO-detection":
        return (jm.TinyYOLO().detection_conf(VOC_PRIORS),
                pm.TinyYOLO().detection_conf(VOC_PRIORS))
    return getattr(jm, name)().conf(), getattr(pm, name)().conf()


def _layers_and_types(conf, layer_cls):
    """(layer, input type) of every layer of a configuration of either
    package."""
    if hasattr(conf, "layers"):
        return list(zip(conf.wired_layers(), conf.layer_input_types()))
    types = conf.vertex_input_types()
    return [(o, types[n][0]) for n, (o, _) in conf.wired_vertices().items()
            if isinstance(o, layer_cls)]


def _port_count(conf):
    meta = torch.device("meta")
    return sum(t.numel() for layer, it in _layers_and_types(conf, Layer)
               for t in tree_leaves(layer.init(None, it, meta)[0]))


def _jax_count(conf):
    from deeplearning4j_tpu.nn.conf.layers import Layer as JLayer
    total = 0
    for layer, it in _layers_and_types(conf, JLayer):
        shapes = jax.eval_shape(lambda k, ll=layer, tt=it: ll.init(k, tt)[0], jax.random.key(0))
        total += sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    return total


def test_models_export_the_jax_package_names():
    names = {n for n in dir(jm) if n[:1].isupper()}
    assert names == {n for n in dir(pm) if n[:1].isupper()} == set(pm.__all__)
    assert set(ZOO) | {"ZooModel"} == names


@pytest.mark.parametrize("name", ZOO + ["TinyYOLO-detection"])
def test_full_size_conf_json_and_parameter_count_match_jax(name):
    jconf, pconf = _confs(name)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    loaded = type(pconf).from_json(jconf.to_json())
    assert json.loads(loaded.to_json()) == json.loads(jconf.to_json())
    assert type(jconf).from_json(pconf.to_json()).to_json() == jconf.to_json()
    assert _port_count(pconf) == _jax_count(jconf) > 0


@pytest.mark.parametrize("name,blocks", [("TinyYOLO-detection", 7), ("FaceNetNN4Small2", 37),
                                         ("InceptionResNetV1", 127)])
def test_full_size_fuse_matches_jax(name, blocks):
    jconf, pconf = _confs(name)
    fused = pconf.fused()
    assert json.loads(fused.to_json()) == json.loads(jax_fuse(jconf).to_json())
    objs = (list(fused.layers) if hasattr(fused, "layers")
            else [o for o, _ in fused.vertices.values()])
    assert sum(isinstance(o, FusedConvBNActivation) for o in objs) == blocks
    if name != "TinyYOLO-detection":
        assert not any(type(o).__name__ == "BatchNormalization" for o in objs)
    else:
        assert {o.activation for o in objs if isinstance(o, FusedConvBNActivation)} == \
            {"leakyrelu"}
        assert [o.n_out for o in objs if isinstance(o, FusedConvBNActivation)] == \
            [16, 32, 64, 128, 256, 512, 1024]


# ---------------------------------------------------------------- fold_bn
def _randomize_bn_stats(net, seed=0):
    rng = np.random.default_rng(seed)
    items = net.state.items() if isinstance(net.state, dict) else enumerate(net.state)
    for _, s in items:
        if "mean" in s:
            s["mean"].copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(tuple(s["mean"].shape))).astype(np.float32)))
            s["var"].copy_(torch.from_numpy(
                (0.5 + rng.random(tuple(s["var"].shape))).astype(np.float32)))


def _has_bn(conf):
    objs = (list(conf.layers) if hasattr(conf, "layers")
            else [o for o, _ in conf.vertices.values()])
    return any(type(o).__name__ in ("BatchNormalization", "FusedConvBNActivation")
               for o in objs)


def _jax_twin(net):
    """The JAX package's network on the port network's weights (no JAX
    init: its params and state are set directly)."""
    cls = JaxGraph if isinstance(net, ComputationGraph) else JaxNet
    from deeplearning4j_tpu.nn.conf.graph import ComputationGraphConfiguration as JCGC
    from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLC
    jcls = JCGC if isinstance(net, ComputationGraph) else JMLC
    jnet = cls(jcls.from_json(net.conf.to_json()))

    def host(tree):
        if isinstance(tree, dict) and all(isinstance(v, dict) for v in tree.values()):
            return {k: {n: jnp.asarray(t.numpy()) for n, t in v.items()} for k, v in tree.items()}
        return [{n: jnp.asarray(t.numpy()) for n, t in p.items()} for p in tree]

    jnet.params, jnet.state = host(net.params), host(net.state)
    return jnet


def _out(net, x):
    """The network's output as a numpy array."""
    out = (net.output_single(x) if isinstance(net, (ComputationGraph, JaxGraph))
           else net.output(x))
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("model_cls,shape,folds", [
    ("LeNet", None, False),
    ("SimpleCNN", (32, 32, 3), False),
    ("AlexNet", (96, 96, 3), False),
    ("VGG16", (64, 64, 3), False),
    ("VGG19", (64, 64, 3), False),
    ("ResNet50", (32, 32, 3), True),
    ("Darknet19", (64, 64, 3), True),
    ("GoogLeNet", (64, 64, 3), False),
    ("InceptionResNetV1", (96, 96, 3), True),
    ("FaceNetNN4Small2", (96, 96, 3), True),
])
def test_fold_bn_zoo_parity(model_cls, shape, folds):
    kw = {"num_classes": 4}
    if shape is not None:
        kw["input_shape"] = shape
    model = getattr(pm, model_cls)(**kw)
    net = model.init(device="cpu")
    _randomize_bn_stats(net)
    folded = fold_bn(net)
    if folds:
        assert not _has_bn(folded.conf)
        n_before = len(getattr(net.conf, "layers", None) or net.conf.vertices)
        n_after = len(getattr(folded.conf, "layers", None) or folded.conf.vertices)
        assert n_after < n_before
    if model_cls == "LeNet":
        x = np.zeros((2, 784), np.float32)
    else:
        x = np.random.default_rng(1).standard_normal((2,) + model.input_shape).astype(np.float32)
    o0, o1 = _out(net, x), _out(folded, x)
    np.testing.assert_allclose(o1, o0, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(o0, _out(_jax_twin(net), x), rtol=1e-4, atol=1e-5)


def test_zoo_init_fold_bn_flag_and_fused_and_transfer_learned_networks():
    net = pm.Darknet19(num_classes=3, input_shape=(32, 32, 3)).init(device="cpu", fold_bn=True)
    assert not _has_bn(net.conf)
    assert net.output(np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 3)
    conf = (JNNC.builder().seed(2).list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3), has_bias=False))
            .layer(jnorm.BatchNormalization())
            .layer(jlay.ActivationLayer(activation="relu"))
            .layer(jconv.SeparableConvolution2D(n_out=5, convolution_mode="same"))
            .layer(jnorm.BatchNormalization())
            .layer(jlay.OutputLayer(n_out=3))
            .set_input_type(JIT.convolutional(8, 8, 3)).build())
    pconf = conf_from_jax_json(conf.to_json())
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(np.float32)
    for c in (pconf, pconf.fused()):
        n = MultiLayerNetwork(c, device="cpu").init()
        _randomize_bn_stats(n)
        f = fold_bn(n)
        assert not _has_bn(f.conf)
        np.testing.assert_allclose(f.output(x).numpy(), n.output(x).numpy(), rtol=2e-4,
                                   atol=2e-5)
    # a transfer-learned network (the output layer replaced, the rest kept)
    base = MultiLayerNetwork(pconf, device="cpu").init()
    _randomize_bn_stats(base)
    tl_conf = dataclasses.replace(pconf, layers=pconf.layers[:-1] + (OutputLayer(n_out=2),))
    tl = MultiLayerNetwork(tl_conf, device="cpu").init(seed=5)
    tl.set_params(base.params[:-1] + [tl.params[-1]], base.state[:-1] + [tl.state[-1]])
    folded_tl = fold_bn(tl)
    assert not _has_bn(folded_tl.conf)
    np.testing.assert_allclose(folded_tl.output(x).numpy(), tl.output(x).numpy(), rtol=2e-4,
                               atol=2e-5)


def _bn_conf():
    return (JNNC.builder().seed(21).weight_init("relu").list()
            .layer(jconv.ConvolutionLayer(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                                          has_bias=False))
            .layer(jnorm.BatchNormalization())
            .layer(jlay.ActivationLayer(activation="relu"))
            .layer(jconv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(jlay.DenseLayer(n_out=16, activation="relu"))
            .layer(jlay.OutputLayer(n_out=5))
            .set_input_type(JIT.convolutional(8, 8, 3)).build())


def _twin_pair(jconf):
    net = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu").init()
    _randomize_bn_stats(net, seed=3)
    return _jax_twin(net), net


def test_quantize_fold_true_on_a_bn_network_matches_jax():
    jnet, net = _twin_pair(_bn_conf())
    jnet.init = None  # the twin carries its params: never re-drawn
    batches = [np.random.default_rng(i).standard_normal((6, 8, 8, 3)).astype(np.float32)
               for i in range(2)]
    jrec = jax_calibrate(jnet, batches, fold=True)
    prec = calibrate(net, batches, fold=True)
    assert prec.signature == CalibrationRecord.from_json(jrec.to_json()).signature
    for k, v in CalibrationRecord.from_json(jrec.to_json()).ranges.items():
        for stat in ("min", "max", "scale"):
            np.testing.assert_allclose(prec.ranges[k][stat], v[stat], rtol=1e-4, err_msg=k)
    jq = jax_quantize(jnet, jrec, fold=True)
    pq = quantize(net, CalibrationRecord.from_json(jrec.to_json()), fold=True)
    assert not _has_bn(pq.conf)
    x = np.random.default_rng(9).standard_normal((4, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(pq.output(x).numpy(), np.asarray(jq.output(x)), rtol=1e-4,
                               atol=1e-5)


def test_parallel_inference_fold_bn_serves_the_folded_network():
    from deeplearning4j_tpu.perf.fusion import fold_bn as jax_fold_bn
    jnet, net = _twin_pair(_bn_conf())
    pi = ParallelInference(net, fold_bn=True, device="cpu")
    try:
        assert not _has_bn(pi.model.conf)
        x = np.random.default_rng(4).standard_normal((3, 8, 8, 3)).astype(np.float32)
        np.testing.assert_allclose(pi.output(x), fold_bn(net).output(x).numpy(), rtol=1e-6)
        np.testing.assert_allclose(pi.output(x), net.output(x).numpy(), rtol=2e-4, atol=2e-5)
        jfolded = jax_fold_bn(jnet)
        assert json.loads(pi.model.conf.to_json()) == json.loads(jfolded.conf.to_json())
        np.testing.assert_allclose(pi.output(x), np.asarray(jfolded.output(x)), rtol=1e-4,
                                   atol=1e-5)
    finally:
        pi.shutdown()


# ------------------------------------------------------------ zips, train
def _members(path):
    import io
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: (dict(np.load(io.BytesIO(z.read(n)))) if n.endswith(".npz") else None)
                for n in z.namelist()}


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        if a[name] is None or name == "rngState.npz":
            continue
        assert sorted(a[name]) == sorted(b[name]), name
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k], err_msg=f"{name}:{k}")


def _yolo_batch(side, classes=20, mb=2, seed=0):
    """tests/test_layer_families.py's fixture form: 1-3 boxes an image."""
    grid = side // 32
    rng = np.random.default_rng(seed)
    x = rng.random((mb, side, side, 3), dtype=np.float32)
    lab = np.zeros((mb, grid, grid, 4 + classes), np.float32)
    for e in range(mb):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(0, grid), rng.integers(0, grid)
            w, h = rng.uniform(0.5, 2.0, 2)
            x1, y1 = cx + 0.5 - w / 2, cy + 0.5 - h / 2
            lab[e, cy, cx, :] = 0
            lab[e, cy, cx, :4] = [x1, y1, x1 + w, y1 + h]
            lab[e, cy, cx, 4 + rng.integers(0, classes)] = 1.0
    return x, lab


def _moved_updater_state(tree, seed):
    """An updater state (optax's, on the JAX side) with every float slot
    moved off its init value and every step count advanced, as training
    leaves it."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return jnp.asarray(a + 0.01 * rng.random(a.shape).astype(a.dtype))
        return jnp.asarray(a + 3)

    return jax.tree_util.tree_map(move, tree)


@pytest.mark.parametrize("model", ["TinyYOLO", "FaceNetNN4Small2"])
def test_zips_cross_both_ways(tmp_path, model, monkeypatch):
    """A JAX-written zip (trained-looking updater state; moved CenterLoss
    centers) restored by the port and written again: the same members and
    arrays bitwise; then the port's zip after one port step restored by the
    JAX package's ``restore``: the same parameters and state bitwise. The
    JAX restore's random init, which the zip's arrays overwrite, is
    replaced by zeros of the twin's structure (its eager per-layer init
    takes tens of seconds for these graphs on the CPU)."""
    if model == "TinyYOLO":
        side = 64
        pconf = pm.TinyYOLO(input_shape=(side, side, 3)).detection_conf(VOC_PRIORS)
        x, y = _yolo_batch(side)
        net = MultiLayerNetwork(pconf, "cpu").init()
    else:
        pconf = pm.FaceNetNN4Small2(num_classes=4).conf()
        x = np.random.default_rng(3).random((2, 96, 96, 3), dtype=np.float32)
        y = np.eye(4, dtype=np.float32)[[1, 3]]
        net = ComputationGraph(pconf, "cpu").init()
        net.params["lossLayer"]["cL"].copy_(torch.randn(net.params["lossLayer"]["cL"].shape))
    _randomize_bn_stats(net)
    jnet = _jax_twin(net)
    if isinstance(jnet, JaxGraph):
        jnet.opt_state = {n: _moved_updater_state(jnet._txs[n].init(jnet.params[n]), i)
                          for i, n in enumerate(jnet._layer_names)}
    else:
        jnet.opt_state = [_moved_updater_state(tx.init(p), i)
                          for i, (tx, p) in enumerate(zip(jnet._txs, jnet.params))]
    jnet._rng = jax.random.key(0)
    jnet.iteration = 3
    a, b, c = (str(tmp_path / f"{n}.zip") for n in "abc")
    jser.write_model(jnet, a)
    restored = pser.restore(a, device="cpu")
    pser.write_model(restored, b)
    _assert_same_arrays(_members(a), _members(b))
    restored.fit(DataSet(x, y))
    pser.write_model(restored, c)
    zeros = (lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree))

    def template_init(self, *args, **kw):
        self.params, self.state, self.opt_state = (zeros(t) for t in
                                                   (jnet.params, jnet.state, jnet.opt_state))
        self._rng = jax.random.key(0)
        return self

    monkeypatch.setattr(type(jnet), "init", template_init)
    back = jser.restore(c)
    for tree, jtree in ((restored.params, back.params), (restored.state, back.state)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, p in items:
            for n, v in p.items():
                np.testing.assert_array_equal(np.asarray(jtree[k][n]), v.numpy(),
                                              err_msg=f"{k}/{n}")
    assert back.iteration == restored.iteration == 4


def test_tiny_yolo_trains_like_jax():
    """Two steps of the model's own Nesterovs through the fused blocks
    against the JAX package's unfused network on the same weights."""
    side = 64
    pconf = pm.TinyYOLO(input_shape=(side, side, 3)).detection_conf(VOC_PRIORS)
    net = MultiLayerNetwork(pconf, "cpu").init()
    _randomize_bn_stats(net)
    jnet = _jax_twin(net)
    jnet.opt_state = [tx.init(p) for tx, p in zip(jnet._txs, jnet.params)]
    jnet._rng = jax.random.key(0)
    from deeplearning4j_tpu_torch.perf.fusion import fuse_network
    fused = fuse_network(net)
    assert sum(isinstance(layer, FusedConvBNActivation) for layer in fused.layers) == 7
    x, y = _yolo_batch(side, mb=3, seed=2)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        fused.fit(DataSet(x, y))
        np.testing.assert_allclose(fused.score(), float(jnet.score()), rtol=1e-4)


def test_init_pretrained_reads_a_local_zip(tmp_path, monkeypatch):
    net = pm.SimpleCNN(num_classes=3, input_shape=(16, 16, 3)).init(device="cpu")
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="DL4J_TPU_PRETRAINED_DIR"):
        pm.SimpleCNN().init_pretrained(device="cpu")
    pser.write_model(net, os.path.join(str(tmp_path), "simplecnn.zip"))
    back = pm.SimpleCNN().init_pretrained(device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(tree_leaves(back.params),
                                                 tree_leaves(net.params)))
