"""The model and checkpoint zip, read and written by both packages, on the
CPU.

- A JAX-written zip restored in the port, and the port's zip of that
  restored network, hold the same members' keys with bitwise-equal arrays
  (``coefficients.npz``: parameters and running stats; ``updaterState.npz``:
  optax's paths), for a MultiLayerNetwork (dense, batch norm, a layer
  without parameters, output) and a graph, under each of the nine
  updaters; then both packages take the same step on the same batch, and
  the port's zip of its stepped network, restored by the JAX package,
  takes one more step beside the port. Parameters after each step agree
  within float32 rounding (rtol 1e-5, atol 1e-6: torch and XLA sum the
  same products in other orders).
- A port checkpoint (``CheckpointManager``) restored by the JAX package's
  ``restore_checkpoint``, and a JAX checkpoint directory restored by the
  port's manager with its resume marker, continuing to the same
  parameters within the same limits.
- The ride-alongs: ``quantization.json`` restored, and zips carrying what
  the port has not ported refused by name; ``model_guesser``.

The JAX side runs as its own tests run it (XLA on the CPU). Configurations
are built by the JAX package and cross as JSON; data comes from numpy with
fixed seeds; no layer uses dropout.
"""

import io
import json
import pathlib
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JaxGraphBuilder
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JaxMergeVertex
from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.quant.calibrate import CalibrationRecord as JaxCalibrationRecord
from deeplearning4j_tpu.utils import serialization as jser

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.utils import model_guesser
from deeplearning4j_tpu_torch.utils import serialization as pser

UPDATERS = {
    "Sgd": dict(learning_rate=0.1), "NoOp": {},
    "Nesterovs": dict(learning_rate=0.05, momentum=0.9),
    "Adam": dict(learning_rate=1e-2), "AdaMax": dict(learning_rate=1e-2),
    "Nadam": dict(learning_rate=1e-2), "AdaGrad": dict(learning_rate=0.1),
    "RmsProp": dict(learning_rate=1e-2), "AdaDelta": {},
}
RTOL, ATOL = 1e-5, 1e-6


def _jax_net(kind, updater="Sgd", seed=3, **upd_kw):
    upd = getattr(jupd, updater)(**{**UPDATERS[updater], **upd_kw})
    if kind == "multilayer":
        conf = (JaxNNC.builder().seed(seed).updater(upd).weight_init("xavier").list()
                .layer(jl.DenseLayer(n_out=6, activation="tanh"))
                .layer(JaxBN())
                .layer(jl.ActivationLayer(activation="relu"))
                .layer(jl.OutputLayer(n_out=3, loss="mcxent"))
                .set_input_type(JaxInputType.feed_forward(4)).build())
        return JaxNet(conf).init()
    parent = JaxNNC.builder().seed(seed).updater(upd).weight_init("xavier")
    conf = (JaxGraphBuilder(parent).add_inputs("in")
            .add_layer("d1", jl.DenseLayer(n_out=5, activation="relu"), "in")
            .add_layer("d2", jl.DenseLayer(n_out=5, activation="tanh"), "in")
            .add_vertex("merge", JaxMergeVertex(), "d1", "d2")
            .add_layer("out", jl.OutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent"), "merge")
            .set_outputs("out").set_input_types(JaxInputType.feed_forward(4)).build())
    return JaxGraph(conf).init()


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])


def _members(path):
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        arrays = {m: dict(np.load(io.BytesIO(z.read(m))))
                  for m in ("coefficients.npz", "updaterState.npz") if m in names}
        return names, arrays, json.loads(z.read("metadata.json"))


def _jax_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_params(net):
    """Port parameters in the JAX package's leaf order: a list by index, a
    dict by sorted key."""
    flat = pser._flat(net.params, "", {})

    def order(path):
        head, *rest = path.split("/")
        return (int(head) if isinstance(net.params, list) else head, rest)

    return [flat[k].detach().numpy() for k in sorted(flat, key=order)]


def _close(port_net, jax_params):
    want = _jax_leaves(jax_params)
    got = _port_params(port_net)
    assert len(want) == len(got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("updater", sorted(UPDATERS))
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_zip_crosses_both_ways_under_each_updater(tmp_path, kind, updater):
    jnet = _jax_net(kind, updater)
    (x1, y1), (x2, y2), (x3, y3) = _batch(1), _batch(2), _batch(3)
    jnet.fit(JaxDataSet(x1, y1))
    jnet.fit(JaxDataSet(x2, y2))
    a, b, c = (str(tmp_path / f"{n}.zip") for n in "abc")
    jser.write_model(jnet, a)

    # JAX -> port: the same members, keys and arrays, bitwise
    net = pser.restore(a, device="cpu")
    assert (net.iteration, net.epoch) == (2, 2)
    pser.write_model(net, b)
    (na, arr_a, meta_a), (nb, arr_b, meta_b) = _members(a), _members(b)
    assert na == nb
    for member in arr_a:
        assert set(arr_a[member]) == set(arr_b[member]), member
        for k in arr_a[member]:
            assert arr_a[member][k].dtype == arr_b[member][k].dtype, k
            np.testing.assert_array_equal(arr_a[member][k], arr_b[member][k], err_msg=k)
    assert {k: meta_b[k] for k in meta_a} == meta_a

    # one step each on the same batch
    jnet.fit(JaxDataSet(x3, y3))
    net.fit(DataSet(x3, y3))
    _close(net, jnet.params)

    # port -> JAX: restored bitwise, then one more step each
    pser.write_model(net, c)
    back = jser.restore(c)
    for got, want in zip(_jax_leaves(back.params), _port_params(net)):
        np.testing.assert_array_equal(got, want)
    assert (back.iteration, back.epoch) == (net.iteration, net.epoch) == (3, 3)
    back.fit(JaxDataSet(x1, y1))
    net.fit(DataSet(x1, y1))
    _close(net, back.params)


def test_learning_rate_schedule_count_crosses(tmp_path):
    """A decay policy keeps optax's schedule count (``k/1/count``), which
    the port reads as its step count and writes back."""
    jnet = _jax_net("multilayer", "Adam", lr_policy="exponential", lr_decay_rate=0.5)
    x, y = _batch(4)
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
    jser.write_model(jnet, str(tmp_path / "a.zip"))
    net = pser.restore(str(tmp_path / "a.zip"), device="cpu")
    assert net.opt_state[0]["count"] == 3
    pser.write_model(net, str(tmp_path / "b.zip"))
    ua = _members(str(tmp_path / "a.zip"))[1]["updaterState.npz"]
    ub = _members(str(tmp_path / "b.zip"))[1]["updaterState.npz"]
    assert set(ua) == set(ub) and "0/1/count" in ub
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    _close(net, jnet.params)


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_port_checkpoint_read_by_jax_restore_checkpoint(tmp_path, kind):
    jnet = _jax_net(kind, "Adam")
    net = pser.restore(_write(jnet, tmp_path / "j.zip"), device="cpu")
    cm = CheckpointManager(tmp_path / "ck", async_write=False, device="cpu")
    x, y = _batch(5)
    net.fit(DataSet(x, y))
    name = cm.save(net)
    cm.close()
    names, _, meta = _members(str(tmp_path / "ck" / name))
    assert meta["has_rng"] is False and meta["has_torch_generator"] is True
    assert "torchGeneratorState.npz" in names and "rngState.npz" not in names
    back, jmeta = jser.restore_checkpoint(str(tmp_path / "ck" / name))
    assert (back.iteration, back.epoch) == (1, 1) and jmeta["batch_in_epoch"] == 0
    for got, want in zip(_jax_leaves(back.params), _port_params(net)):
        np.testing.assert_array_equal(got, want)
    want = {}
    for k, updater in (net._updaters.items() if kind == "graph"
                       else enumerate(net._updaters)):
        want.update(pser.updater_arrays(k, updater, net.opt_state[k]))
    got = jser._flatten_with_paths(back.opt_state)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _write(jnet, path):
    jser.write_model(jnet, str(path))
    return str(path)


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_jax_checkpoint_dir_resumed_by_port_manager(tmp_path, kind):
    """The JAX package's manager checkpoints a crashed run; the port's
    manager reads the same directory, arms the resume at the same step,
    seeds dropout anew from conf.seed + 1, and its resumed fit ends where
    the JAX package's resumed fit ends, within float32 rounding."""
    from deeplearning4j_tpu.checkpoint import FaultInjector as JaxFaultInjector
    from deeplearning4j_tpu.checkpoint import SimulatedCrash as JaxSimulatedCrash
    batches = [JaxDataSet(*_batch(10 + i)) for i in range(3)]
    jcm = JaxCheckpointManager(str(tmp_path / "ck"), save_every_n_steps=2,
                               async_write=False)
    crashed = _jax_net(kind, "Adam").set_listeners(JaxFaultInjector(kill_at_step=5))
    with pytest.raises(JaxSimulatedCrash):
        crashed.fit(batches, num_epochs=3, checkpoint_manager=jcm)
    jcm.close()
    jres = JaxCheckpointManager(str(tmp_path / "ck")).restore_latest()
    net = CheckpointManager(tmp_path / "ck", device="cpu").restore_latest()
    rs = net._resume_state
    assert (rs.step, rs.epoch, rs.batch_in_epoch) == (4, 1, 1)
    for got, want in zip(_port_params(net), _jax_leaves(jres.params)):
        np.testing.assert_array_equal(got, want)
    fresh = torch.Generator().manual_seed(net.conf.seed + 1)
    assert torch.equal(net._gen.get_state(), fresh.get_state())
    jres.fit(batches, num_epochs=3)
    net.fit([DataSet(b.features, b.labels) for b in batches], num_epochs=3)
    assert (net.iteration, net.epoch) == (jres.iteration, jres.epoch) == (9, 3)
    _close(net, jres.params)


def test_quantization_record_rides_along(tmp_path):
    rec = JaxCalibrationRecord(model_type="MultiLayerNetwork", observer="minmax",
                               percentile=None, batches=2,
                               signature=(("layer0", "DenseLayer", 6),),
                               ranges={"layer0": {"min": -1.0, "max": 2.0, "amax": 2.0,
                                                  "scale": 2.0 / 127, "zero_point": 0.0}})
    jnet = _jax_net("multilayer")
    jnet._quant_calibration = rec
    net = pser.restore(_write(jnet, tmp_path / "q.zip"), device="cpu")
    assert net._quant_calibration.to_dict() == rec.to_dict()
    pser.write_model(net, str(tmp_path / "p.zip"))
    assert jser.restore(str(tmp_path / "p.zip"))._quant_calibration.to_dict() == rec.to_dict()


@pytest.mark.parametrize("member", ["tuning.json", "compressState.npz", "augmentation"])
def test_zip_with_unported_module_is_refused_by_name(tmp_path, member):
    src = _write(_jax_net("multilayer"), tmp_path / "a.zip")
    out = str(tmp_path / "b.zip")
    with zipfile.ZipFile(src) as z, zipfile.ZipFile(out, "w") as w:
        for name in z.namelist():
            data = z.read(name)
            if name == "metadata.json" and member == "augmentation":
                data = json.dumps({**json.loads(data), "augmentation": {"flip_prob": 0.5}})
            w.writestr(name, data)
        if member == "tuning.json":
            from deeplearning4j_tpu.perf.autotune import TuningRecord, conf_signature
            sig = conf_signature(_jax_net("multilayer").conf)
            rec = TuningRecord(model_type="MultiLayerConfiguration", dtype="float32",
                               signature=sig, tuned_signature=sig, batch_size=8,
                               fusion=False, donate=True, remat={}, buckets=(8,),
                               objective={"step_seconds": 0.5}, baseline={},
                               candidates_searched=1)
            w.writestr(member, rec.to_json())
        elif member != "augmentation":
            w.writestr(member, b"{}")
    if member == "augmentation":
        # ported: the zip's augmentation is re-enabled on the network
        from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
        assert pser.restore(out, device="cpu").augmentation == ImageAugmentation(flip_prob=0.5)
        return
    if member == "compressState.npz":
        # ported (parallel/compress.py): without a scheme in the metadata the
        # member is ignored, as the JAX package ignores it; a checkpoint with
        # one restores its scheme (tests/test_torch_compress.py)
        assert pser.restore(out, device="cpu").grad_compression is None
        assert jser.restore(out).grad_compression is None
        return
    # ported (perf/autotune.py): the record is attached again, in both packages
    assert pser.restore(out, device="cpu")._tuning_record.to_dict() == rec.to_dict()
    assert jser.restore(out)._tuning_record.to_dict() == rec.to_dict()


# the m(x) of tests/data/keras/dense_sequential.h5 (written by Keras 3.13.1's
# model.save for Sequential([Input((5,)), Dense(4, "relu"), Dense(2,
# "softmax")]) after set_random_seed(0)), x = default_rng(0) normals (3, 5)
KERAS_OUT = np.array([[0.579258382320404, 0.42074164748191833],
                      [0.6601154208183289, 0.33988454937934875],
                      [0.4465109705924988, 0.5534890294075012]])


def test_model_guesser(tmp_path):
    jnet = _jax_net("graph")
    path = _write(jnet, tmp_path / "g.zip")
    net = model_guesser.load_model_guess(path, device="cpu")
    assert isinstance(net, ComputationGraph)
    for got, want in zip(_port_params(net), _jax_leaves(jnet.params)):
        np.testing.assert_array_equal(got, want)
    conf = model_guesser.load_config_guess(jnet.conf.to_json())
    assert conf.to_json() == jnet.conf.to_json()
    # a Keras file imports in both packages (modelimport/); a file that is
    # neither a framework zip nor a Keras file raises the JAX package's
    # ValueError naming both formats
    from deeplearning4j_tpu.utils import model_guesser as jax_guesser
    fake = tmp_path / "m.h5"
    fake.write_bytes(b"\x89HDF\r\n\x1a\n")
    for guess in (lambda p: model_guesser.load_model_guess(p, device="cpu"),
                  jax_guesser.load_model_guess):
        with pytest.raises(ValueError, match="neither a framework model zip nor a Keras file"):
            guess(str(fake))
    real = str(pathlib.Path(__file__).parent / "data" / "keras" / "dense_sequential.h5")
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    got = model_guesser.load_model_guess(real, device="cpu")
    want = jax_guesser.load_model_guess(real)
    assert type(got).__name__ == "MultiLayerNetwork" and got.conf.to_json() == want.conf.to_json()
    for g, w in zip(_port_params(got), _jax_leaves(want.params)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got.output(x).numpy(), np.asarray(want.output(x)), atol=1e-6)
    np.testing.assert_allclose(got.output(x).numpy(), KERAS_OUT, atol=1e-6)
