"""The port's Keras import (``modelimport/``) against the JAX package's, on
the CPU. A handful of Keras models, built once for the module with the
local Keras and saved as legacy HDF5 (and as Keras 3 ``.keras`` zips), are
imported by both packages: the networks' configurations and every
parameter and running-statistics leaf are equal, and the port's outputs
agree with Keras's own and (for the BN CNN and the functional model, one
JAX compile each) with the JAX package's within 1e-5 (float32 through
different convolution and recurrence code; 1e-4 for batch norm in
inference mode, as the JAX package's own test holds it). Keras's ResNet50
configuration (``tests/data/keras/resnet50_config.json``, the JSON
``keras.applications.ResNet50(weights=None).to_json()`` writes) converts
to the same configuration in both packages and fuses to 53 blocks in both.
"""

import json
import os

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu.modelimport import keras as jk  # noqa: E402
from deeplearning4j_tpu.modelimport import trainedmodels as jtm  # noqa: E402
from deeplearning4j_tpu.perf.fusion import fuse as jfuse  # noqa: E402

from deeplearning4j_tpu_torch.datasets import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    Hdf5Archive, KerasImportError, import_keras_model, import_keras_model_and_weights,
    import_keras_sequential_model_and_weights, register_keras_layer)
from deeplearning4j_tpu_torch.modelimport import keras as pk  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import trainedmodels as ptm  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.perf.fusion import fuse  # noqa: E402

RESNET50_JSON = os.path.join(os.path.dirname(__file__), "data", "keras",
                             "resnet50_config.json")
L = keras.layers


def _mlp():
    return keras.Sequential([L.Input((6,)), L.Dense(8, activation="tanh"),
                             L.Dense(3, activation="softmax")])


def _cnn_bn():
    return keras.Sequential([
        L.Input((10, 10, 2)), L.Conv2D(4, (3, 3), padding="same"), L.BatchNormalization(),
        L.Activation("relu"), L.MaxPooling2D((2, 2)), L.Conv2D(6, (3, 3), use_bias=False),
        L.BatchNormalization(), L.Activation("relu"), L.Flatten(),
        L.Dense(3, activation="softmax")])


def _lstm():
    return keras.Sequential([L.Input((7, 5)), L.LSTM(12, return_sequences=True), L.LSTM(8),
                             L.Dense(4, activation="softmax")])


def _functional():
    inp = L.Input((8, 8, 3))
    a = L.Conv2D(4, (3, 3), padding="same", activation="relu")(inp)
    b = L.Conv2D(4, (1, 1), padding="same")(inp)
    s = L.Add()([a, b])
    c = L.Concatenate()([s, L.Conv2D(2, (5, 5), padding="same", activation="relu")(inp)])
    out = L.Dense(3, activation="softmax")(L.GlobalAveragePooling2D()(c))
    return keras.Model(inp, out)


MODELS = {"mlp": (_mlp, (6,)), "cnn_bn": (_cnn_bn, (10, 10, 2)), "lstm": (_lstm, (7, 5)),
          "functional": (_functional, (8, 8, 3))}
# the models whose JAX forward also runs (a JAX compile each): every model's
# configuration and leaves are equal in both packages and its port output
# is held to Keras's, so two JAX forwards cover both network classes
JAX_FORWARD = ("cnn_bn", "functional")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{name: (keras model, .h5 path, .keras path, input batch)}; the BN
    model is fitted one epoch first so its running statistics are not the
    initial ones."""
    root = tmp_path_factory.mktemp("keras")
    rng = np.random.default_rng(0)
    out = {}
    for name, (build, shape) in MODELS.items():
        keras.utils.set_random_seed(1)
        m = build()
        m.compile(loss="categorical_crossentropy", optimizer="sgd")
        x = rng.standard_normal((4,) + shape).astype(np.float32)
        if name == "cnn_bn":
            xb = rng.standard_normal((32,) + shape).astype(np.float32)
            m.fit(xb, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)], epochs=1,
                  verbose=0)
        h5, v3 = str(root / f"{name}.h5"), str(root / f"{name}.keras")
        m.save(h5)
        m.save(v3)
        out[name] = (m, h5, v3, x)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves(v) for v in tree]
    return np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert json.dumps(jsonable(g)) == json.dumps(jsonable(w))


def jsonable(tree):
    if isinstance(tree, dict):
        return {k: jsonable(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [jsonable(v) for v in tree]
    return [str(tree.dtype), list(tree.shape), tree.ravel().view(np.uint8).tolist()]


def _out(net, x):
    out = net.output_single(x) if isinstance(net, ComputationGraph) else net.output(x)
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


def _jout(net, x):
    return np.asarray(net.output_single(x) if hasattr(net, "output_single")
                      else net.output(x))


@pytest.mark.parametrize("fmt", ["h5", "keras"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_import_matches_jax_and_keras(saved, name, fmt):
    m, h5, v3, x = saved[name]
    path = h5 if fmt == "h5" else v3
    net, jnet = import_keras_model(path, device="cpu"), jk.import_keras_model(path)
    assert type(net).__name__ == type(jnet).__name__
    assert net.conf.to_json() == jnet.conf.to_json()
    _assert_trees_equal(net.params, jnet.params)
    _assert_trees_equal(net.state, jnet.state)
    want = np.asarray(m(x, training=False))
    atol = 1e-4 if name == "cnn_bn" else 1e-5
    np.testing.assert_allclose(_out(net, x), want, atol=atol)
    if fmt == "h5" and name in JAX_FORWARD:
        np.testing.assert_allclose(_out(net, x), _jout(jnet, x), atol=1e-5)


def test_weights_land_on_the_device_as_float32(saved):
    _, h5, _, _ = saved["cnn_bn"]
    net = import_keras_sequential_model_and_weights(h5, device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    for leaf in [v for p in net.params for v in p.values()]:
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"


def test_imported_network_trains_alike(saved):
    """One fit step of the imported BN CNN: the train-mode loss agrees."""
    _, h5, _, x = saved["cnn_bn"]
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    net, jnet = import_keras_model(h5, device="cpu"), jk.import_keras_model(h5)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=1e-5)


def test_an_opened_archive_imports_as_the_file_and_stays_open(saved):
    _, h5, _, x = saved["functional"]
    archive = Hdf5Archive(h5)
    try:
        net = import_keras_model_and_weights(archive, device="cpu")
        assert archive.has_attribute("model_config")  # still open: the caller closes it
        via_path = import_keras_model_and_weights(h5, device="cpu")
        _assert_trees_equal(net.params, via_path.params)
        assert isinstance(import_keras_model(archive, device="cpu"), ComputationGraph)
    finally:
        archive.close()


def test_resnet50_config_converts_alike_and_fuses_to_53():
    with open(RESNET50_JSON, encoding="utf-8") as f:
        raw = f.read()
    assert len(raw.encode()) == 163422
    cfg = json.loads(raw)
    pconf, pspecs = pk._convert_functional(cfg, pk._import_ctx(None, cfg), None)
    jconf, jspecs = jk._convert_functional(cfg, jk._import_ctx(None, cfg), None)
    assert pconf.to_json() == jconf.to_json()
    assert list(pspecs) == list(jspecs) and len(pspecs) == 107
    pf, jf = fuse(pconf), jfuse(jconf)
    assert pf.to_json() == jf.to_json()
    assert sum(isinstance(v[0], FusedConvBNActivation) for v in pf.vertices.values()) == 53


def _error(fn, cls):
    with pytest.raises(cls) as e:
        fn()
    return str(e.value)


def test_refusals_alike(saved, tmp_path):
    _, seq, _, _ = saved["mlp"]
    _, fun, _, _ = saved["functional"]
    pairs = [
        (lambda: import_keras_model_and_weights(seq, device="cpu"),
         lambda: jk.import_keras_model_and_weights(seq)),
        (lambda: import_keras_sequential_model_and_weights(fun, device="cpu"),
         lambda: jk.import_keras_sequential_model_and_weights(fun)),
        (lambda: import_keras_model_and_weights(None, device="cpu"),
         lambda: jk.import_keras_model_and_weights(None)),
    ]
    with h5py.File(seq, "r") as f:
        cfg = json.loads(f.attrs["model_config"])
    cfg["config"]["layers"][1]["class_name"] = "NoSuchLayer"
    bad = json.dumps(cfg)
    pairs.append((lambda: import_keras_sequential_model_and_weights(seq, model_json=bad,
                                                                    device="cpu"),
                  lambda: jk.import_keras_sequential_model_and_weights(seq, model_json=bad)))
    for p, j in pairs:
        assert _error(p, KerasImportError) == _error(j, jk.KerasImportError)


def test_custom_layer_hook(saved):
    m, seq, _, _ = saved["mlp"]
    with h5py.File(seq, "r") as f:
        cfg = json.loads(f.attrs["model_config"])
    cfg["config"]["layers"][1]["class_name"] = "MyDense"
    from deeplearning4j_tpu_torch.modelimport.keras_layers import _dense
    register_keras_layer("MyDense", _dense)
    net = import_keras_sequential_model_and_weights(seq, model_json=json.dumps(cfg),
                                                    device="cpu")
    x = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_allclose(_out(net, x), np.asarray(m(x)), atol=1e-5)


def test_vgg16_preprocessor_alike():
    x = np.random.default_rng(1).uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(ptm.VGG16ImagePreProcessor.preprocess_features(x),
                                  jtm.VGG16ImagePreProcessor.preprocess_features(x))
    pre = ptm.TrainedModels.get_pre_processor("VGG16")
    ds = pre.pre_process(DataSet(x, np.zeros((2, 1), np.float32)))
    np.testing.assert_array_equal(ds.features, jtm.VGG16ImagePreProcessor.preprocess_features(x))
    with pytest.raises(ValueError, match="Unknown trained model"):
        ptm.TrainedModels.get_pre_processor("resnet")
