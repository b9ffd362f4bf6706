"""The port's training extras against the JAX package's, on the CPU:
listeners (``optimize/listeners.py``), memory reports (``nn/memory.py``),
configuration validation (``analysis/validation.py``, ``init(validate=)``,
the meta-device shape check), streaming over HTTP
(``datasets/streaming.py``), ``utils/archive.py`` and
``utils/moving_window.py``.

Networks are built by the JAX package and carried to the port through
their JSON and ``interop.params_from_jax``. Collected scores agree at the
training tests' loss tolerance (rtol 1e-5); checkpoint zips cross both ways
bitwise; evaluation histories are equal; memory-report rows and validation
issue lists are equal (the meta-device drift message names its mechanism,
the rest word for word); activation grids agree within one gray level
(the PNG quantizes activations that differ in the last float32 bits).
"""

import base64
import dataclasses
import io
import json
import os
import tarfile
import threading
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.convolutional as jconv
import deeplearning4j_tpu.nn.conf.graph as jgraph
import deeplearning4j_tpu.nn.conf.layers as jlayers
import deeplearning4j_tpu.nn.conf.recurrent as jrec
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import memory as jmem
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import listeners as jlis
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.utils import serialization as jser

from deeplearning4j_tpu_torch.analysis import ConfigValidationError
from deeplearning4j_tpu_torch.datasets import (DataSet, StreamingDataSetIterator,
                                               StreamingHttpReceiver)
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax, state_from_jax)
from deeplearning4j_tpu_torch.nn import memory as pmem
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves
from deeplearning4j_tpu_torch.optimize import listeners as plis


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's CPU convolution backward crashes in a process that has run
    XLA:CPU programs; the port's CPU path takes native convolutions here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jnet):
    graph = isinstance(jnet, JaxGraph)
    conf = (graph_conf_from_jax_json if graph else conf_from_jax_json)(jnet.conf.to_json())
    net = (ComputationGraph if graph else MultiLayerNetwork)(conf, device="cpu")
    return net.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                          state_from_jax(_host(jnet.state), device="cpu"))


def _conv_jax(updater=None):
    conf = (JaxNNC.builder().seed(11).updater(updater or jupd.Adam(learning_rate=0.01))
            .weight_init("xavier").list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3), convolution_mode="same",
                                          activation="relu"))
            .layer(jconv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(jlayers.DenseLayer(n_out=6, activation="tanh",
                                      updater=jupd.Sgd(learning_rate=0.1, lr_policy="step",
                                                       lr_decay_rate=0.5,
                                                       lr_policy_steps=2)))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(8, 8, 1)).build())
    return JaxMLN(conf).init()


def _batches(n=3, rows=6):
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        out.append((rng.standard_normal((rows, 8, 8, 1)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]))
    return out


class _Store:
    def __init__(self):
        self.updates = []

    def put_update(self, rec):
        self.updates.append(rec)


def _png(b64):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))), np.int16)


def test_listeners_match_jax_on_the_same_run(tmp_path):
    jnet = _conv_jax()
    pnet = _port(jnet)
    eval_batches = _batches(2)
    js, ps = jlis.CollectScoresIterationListener(), plis.CollectScoresIterationListener()
    je = jlis.EvaluativeListener([JaxDataSet(x, y) for x, y in eval_batches], frequency=2,
                                 invocation_type="iteration_end")
    pe = plis.EvaluativeListener([DataSet(x, y) for x, y in eval_batches], frequency=2,
                                 invocation_type="iteration_end")
    jc = jlis.CheckpointListener(str(tmp_path / "jax"), every_n_iterations=2)
    pc = plis.CheckpointListener(str(tmp_path / "port"), every_n_iterations=2)
    jstore, pstore = _Store(), _Store()
    jconvl = jlis.ConvolutionalIterationListener(jstore, frequency=2, session_id="s")
    pconvl = plis.ConvolutionalIterationListener(pstore, frequency=2, session_id="s")
    perf = plis.PerformanceListener(frequency=1)
    prof = plis.ProfilerListener(str(tmp_path / "trace"), start_iteration=1, num_iterations=1)
    jnet.set_listeners(js, je, jc, jconvl)
    pnet.set_listeners(ps, pe, pc, pconvl, perf, prof, plis.ScoreIterationListener(1),
                       plis.TimeIterationListener(3), plis.SleepyTrainingListener(0))
    for x, y in _batches(3):
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
    assert [i for i, _ in ps.scores] == [i for i, _ in js.scores] == [0, 1, 2]
    np.testing.assert_allclose([s for _, s in ps.scores], [s for _, s in js.scores],
                               rtol=1e-5)
    assert len(pe.history) == len(je.history) == 1
    pev, jev = pe.history[0][0], je.history[0][0]
    for stat in ("accuracy", "precision", "recall", "f1"):
        assert getattr(pev, stat)() == pytest.approx(getattr(jev, stat)(), abs=1e-12), stat
    assert perf.samples_per_sec > 0 and perf.batches_per_sec > 0
    # the Chrome trace of iterations 1..2
    assert prof.completed and json.load(open(prof.trace_path))["traceEvents"]
    # checkpoint zips, read across packages
    pz = plis.CheckpointListener.last_checkpoint(str(tmp_path / "port"))
    back = jser.restore(pz)
    for got, want in zip(jax.tree_util.tree_leaves(_host(back.params)),
                         jax.tree_util.tree_leaves(_host(_port_as_jax_tree(pnet)))):
        assert np.array_equal(got, want)
    jback = plis.CheckpointListener.restore_last(str(tmp_path / "jax"), device="cpu")
    assert jback.iteration == 2
    for got, want in zip(tree_leaves(jback.params), tree_leaves(_port(jnet).params)):
        assert torch.equal(got, want)
    # activation grids of the same layers, within one gray level
    assert [u["iteration"] for u in pstore.updates] == [u["iteration"] for u in jstore.updates]
    for pu, ju in zip(pstore.updates, jstore.updates):
        assert pu["type_id"] == ju["type_id"] == "ActivationsListener"
        assert sorted(pu["layers"]) == sorted(ju["layers"])
        for name in ju["layers"]:
            assert np.abs(_png(pu["layers"][name]) - _png(ju["layers"][name])).max() <= 1
    # fit keeps the batch's first example only for a listener that needs it
    assert pnet._last_features.shape == (1, 8, 8, 1)
    plain = _port(jnet)
    plain.set_listeners(plis.CollectScoresIterationListener())
    plain.fit(DataSet(*_batches(1)[0]))
    assert plain._last_features is None


def _port_as_jax_tree(pnet):
    """The port network's parameters as the JAX package lays them out
    (sorted dict keys), for a leaf-by-leaf comparison."""
    return [{k: p[k].numpy() for k in sorted(p)} for p in pnet.params]


def _rows(report):
    return [dataclasses.asdict(r) | {"activation_shape": tuple(r.activation_shape)}
            for r in report.layers]


def _same_report(got, want):
    assert _rows(got) == _rows(want)
    for f in ("model_class", "minibatch", "dtype", "total_param_bytes",
              "total_activation_bytes", "updater_state_bytes", "fused_blocks"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.compiled is None
    # the saved set of one train step, measured on the meta device as the
    # JAX package measures its residual set (tests/test_torch_planner_autotune.py
    # holds the two against each other)
    assert isinstance(got.training_activation_bytes, int) and got.training_activation_bytes > 0


def test_memory_reports_match_jax():
    jnet = _conv_jax()
    pnet = _port(jnet)
    _same_report(pmem.get_memory_report(pnet, minibatch=4),
                 jmem.get_memory_report(jnet, minibatch=4, compile_step=False))
    for dtype in ("float32", "bfloat16"):
        jconf = dataclasses.replace(jnet.conf, dtype=dtype)
        pconf = conf_from_jax_json(jconf.to_json())
        _same_report(pconf.memory_report(minibatch=4),
                     jmem.conf_memory_report(jconf, minibatch=4, training_bytes=False))
    # an input_type override
    it = JaxInputType.convolutional(12, 12, 1)
    _same_report(pconf.memory_report(input_type=InputType.convolutional(12, 12, 1),
                                     minibatch=2),
                 jmem.conf_memory_report(jconf, input_type=it, minibatch=2,
                                         training_bytes=False))
    from tests.test_torch_fused_update import tiny_conv_conf
    jg = tiny_conv_conf(jupd.Nadam(learning_rate=0.01))
    pg = graph_conf_from_jax_json(jg.to_json())
    _same_report(pg.memory_report(minibatch=3),
                 jmem.conf_memory_report(jg, minibatch=3, training_bytes=False))
    # a graph network reports its layer vertices by name, its own bytes
    gnet = ComputationGraph(pg, device="cpu").init()
    rep = pmem.get_memory_report(gnet, minibatch=3)
    assert [r.name for r in rep.layers] == [r.name for r in pg.memory_report(3).layers]
    assert rep.total_param_bytes == 4 * sum(r.num_params for r in rep.layers)


# ------------------------------------------------- validation: broken confs
def _mlp(P, **kw):
    kw = {"n_out": 16, "activation": "relu", **kw}
    return (P.NNC.builder().list().layer(P.Dense(**kw)).layer(P.Out(n_out=4))
            .set_input_type(P.IT.feed_forward(8)).build())


def _mln(P, *layers, it=None):
    b = P.NNC.builder().list()
    for layer in layers:
        b = b.layer(layer)
    return b.set_input_type(it or P.IT.feed_forward(8)).build()


def _graph(P, vertices, inputs=("in",), outputs=("out",), input_types=None):
    return P.CGC(network_inputs=tuple(inputs), vertices=vertices,
                 network_outputs=tuple(outputs),
                 input_types=tuple(input_types or (P.IT.feed_forward(8),)))


CASES = {
    "valid_mlp": lambda P: (_mlp(P), {}),
    "conv_kernel_exceeds_input": lambda P: (_mln(
        P, P.Conv(name="stem", n_out=8, kernel_size=(9, 9)), P.Out(n_out=2),
        it=P.IT.convolutional(6, 6, 1)), {}),
    "pooling_geometry": lambda P: (_mln(
        P, P.Sub(name="pool", kernel_size=(8, 8), stride=(8, 8)), P.Out(n_out=2),
        it=P.IT.convolutional(4, 4, 2)), {}),
    "unknown_activation": lambda P: (_mlp(P, name="d0", activation="rleu"), {}),
    "unknown_loss": lambda P: (_mln(P, P.Out(name="head", n_out=4, loss="msee")), {}),
    "n_out_missing": lambda P: (_mln(P, P.Dense(name="empty"), P.Out(n_out=2)), {}),
    "n_in_mismatch": lambda P: (_mlp(P, name="d", n_in=99), {}),
    "dropout_range": lambda P: (_mlp(P, dropout=1.5), {}),
    "output_midstack": lambda P: (_mln(P, P.Out(name="early", n_out=4),
                                       P.Dense(n_out=2)), {}),
    "sequence_on_ff": lambda P: (_mln(P, P.LSTM(name="rnn1", n_out=8),
                                      P.RnnOut(n_out=2)), {}),
    "labels_ok": lambda P: (_mlp(P), {"labels_shape": (32, 4)}),
    "labels_bad": lambda P: (_mlp(P), {"labels_shape": (32, 7)}),
    "labels_rnn_bad": lambda P: (_mln(P, P.LSTM(n_out=8), P.RnnOut(n_out=3),
                                      it=P.IT.recurrent(4, 10)), {"labels_shape": (2, 3)}),
    "loss_activation_warns": lambda P: (_mln(P, P.Out(n_out=4, loss="mcxent",
                                                      activation="identity")), {}),
    "eval_shape_clean": lambda P: (_mln(
        P, P.Conv(n_out=4, kernel_size=(3, 3), convolution_mode="same"), P.Sub(),
        P.Dense(n_out=16, activation="relu"), P.Out(n_out=3),
        it=P.IT.convolutional(8, 8, 1)), {"eval_shape_check": True}),
    "graph_cycle": lambda P: (_graph(P, {
        "a": (P.Dense(n_out=4), ("in",)), "b": (P.EW(), ("a", "c")),
        "c": (P.Dense(n_out=4), ("b",)), "out": (P.Out(n_out=2), ("c",))}), {}),
    "graph_unknown_input": lambda P: (_graph(P, {
        "a": (P.Dense(n_out=4), ("in", "ghost")), "out": (P.Out(n_out=2), ("a",))}), {}),
    "graph_conv_geometry": lambda P: (_graph(P, {
        "conv1": (P.Conv(n_out=4, kernel_size=(9, 9)), ("in",)),
        "out": (P.Out(n_out=2), ("conv1",))},
        input_types=(P.IT.convolutional(6, 6, 1),)), {}),
    "graph_merge_rank": lambda P: (_graph(P, {
        "m": (P.Merge(), ("i1", "i2")), "out": (P.Out(n_out=2), ("m",))},
        inputs=("i1", "i2"), input_types=(P.IT.feed_forward(8), P.IT.recurrent(8, 5))), {}),
    "graph_elementwise_shape": lambda P: (_graph(P, {
        "add": (P.EW(op="add"), ("i1", "i2")), "out": (P.Out(n_out=2), ("add",))},
        inputs=("i1", "i2"), input_types=(P.IT.feed_forward(8), P.IT.feed_forward(12))), {}),
    "graph_self_loop": lambda P: (_graph(P, {
        "a": (P.EW(), ("in", "a")), "out": (P.Out(n_out=2), ("a",))}), {}),
    "graph_dangling": lambda P: (_graph(P, {
        "a": (P.Dense(n_out=4), ("in",)), "deadend": (P.Dense(n_out=4), ("a",)),
        "out": (P.Out(n_out=2), ("a",))}), {}),
    "graph_output_not_loss": lambda P: (_graph(P, {"a": (P.Dense(n_out=4), ("in",))},
                                               outputs=("a",)), {}),
    "graph_eval_shape_clean": lambda P: (_graph(P, {
        "d1": (P.Dense(n_out=8, activation="relu"), ("in",)),
        "d2": (P.Dense(n_out=8, activation="tanh"), ("in",)),
        "m": (P.Merge(), ("d1", "d2")), "out": (P.Out(n_out=3), ("m",))}),
        {"eval_shape_check": True}),
}


def _namespace(jax_side: bool):
    if jax_side:
        mods = dict(NNC=JaxNNC, IT=JaxInputType, Dense=jlayers.DenseLayer,
                    Out=jlayers.OutputLayer, Conv=jconv.ConvolutionLayer,
                    Sub=jconv.SubsamplingLayer, LSTM=jrec.LSTM, RnnOut=jrec.RnnOutputLayer,
                    CGC=jgraph.ComputationGraphConfiguration, EW=jgraph.ElementWiseVertex,
                    Merge=jgraph.MergeVertex)
    else:
        from deeplearning4j_tpu_torch.nn.conf import convolutional as pconv
        from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
        from deeplearning4j_tpu_torch.nn.conf import layers as players
        from deeplearning4j_tpu_torch.nn.conf import recurrent as prec
        mods = dict(NNC=NeuralNetConfiguration, IT=InputType, Dense=players.DenseLayer,
                    Out=players.OutputLayer, Conv=pconv.ConvolutionLayer,
                    Sub=pconv.SubsamplingLayer, LSTM=prec.LSTM, RnnOut=prec.RnnOutputLayer,
                    CGC=pgraph.ComputationGraphConfiguration, EW=pgraph.ElementWiseVertex,
                    Merge=pgraph.MergeVertex)
    return type("P", (), mods)


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_issue_lists_match_jax(case):
    jconf, kw = CASES[case](_namespace(True))
    pconf, _ = CASES[case](_namespace(False))
    if "labels_shape" in kw and hasattr(jconf, "vertices"):
        kw = {"labels_shapes": kw.pop("labels_shape")}
    want = [(i.rule, i.layer, i.message, i.severity)
            for i in jconf.validate(raise_on_error=False, **kw)]
    got = [(i.rule, i.layer, i.message, i.severity)
           for i in pconf.validate(raise_on_error=False, **kw)]
    assert got == want
    errors = [w for w in want if w[3] == "error"]
    if errors:
        with pytest.raises(ConfigValidationError) as ei:
            pconf.validate(**kw)
        assert len(ei.value.issues) == len(errors)


def test_eval_shape_drift_found_on_meta():
    @dataclasses.dataclass(frozen=True)
    class LyingDense(DenseLayer):
        """output_type deliberately disagrees with apply."""

        def output_type(self, it):
            return InputType.feed_forward(self.n_out + 1)

    conf = (NeuralNetConfiguration.builder().list().layer(LyingDense(name="liar", n_out=4))
            .set_input_type(InputType.feed_forward(8)).build())
    issues = conf.validate(eval_shape_check=True, raise_on_error=False)
    drift = [i for i in issues if i.rule == "eval-shape-drift"]
    assert drift and "liar" in drift[0].layer and "(2, 4)" in drift[0].message


def test_init_validates_with_opt_outs(monkeypatch):
    pconf = _mlp(_namespace(False), activation="rleu")
    with pytest.raises(ConfigValidationError, match="rleu"):
        MultiLayerNetwork(pconf, device="cpu").init()
    assert MultiLayerNetwork(pconf, device="cpu").init(validate=False).params is not None
    gconf = CASES["graph_output_not_loss"](_namespace(False))[0]
    gconf = dataclasses.replace(gconf, vertices={
        "a": (DenseLayer(n_out=4, activation="rleu"), ("in",)),
        "out": (_namespace(False).Out(n_out=2), ("a",))}, network_outputs=("out",))
    with pytest.raises(ConfigValidationError, match="rleu"):
        ComputationGraph(gconf, device="cpu").init()
    monkeypatch.setenv("DL4J_TPU_VALIDATE", "0")
    assert MultiLayerNetwork(pconf, device="cpu").init().params is not None
    assert ComputationGraph(gconf, device="cpu").init().params is not None


# ---------------------------------------------------- streaming, archive, window
def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_streaming_fit_over_http():
    it = StreamingDataSetIterator(queue_size=2, poll_timeout=30)
    rx = StreamingHttpReceiver(it, port=0, max_body_bytes=1 << 20)
    codes = []

    def produce():
        for x, y in _batches(4, rows=5):
            buf = io.BytesIO()
            np.savez(buf, features=x, labels=y)
            codes.append(_post(rx.port, "/push", buf.getvalue()))
        codes.append(_post(rx.port, "/end", b""))

    try:
        net = _port(_conv_jax())
        t = threading.Thread(target=produce)
        t.start()
        net.fit(it)
        t.join()
        assert codes == [200] * 5
        assert it.consumed == it.pushed == 4 and net.iteration == 4
        assert net.last_batch_size == 5 and np.isfinite(net.score())
        assert _post(rx.port, "/nope", b"x") == 404
        assert _post(rx.port, "/push", b"x" * (2 << 20)) == 413
        assert _post(rx.port, "/push", b"not an npz") == 400
    finally:
        rx.stop()


def test_unzip_file_to_refuses_escapes(tmp_path):
    from deeplearning4j_tpu_torch.utils.archive import unzip_file_to
    good = tmp_path / "good.zip"
    with zipfile.ZipFile(good, "w") as z:
        z.writestr("a/b.txt", "ok")
    unzip_file_to(str(good), str(tmp_path / "out"))
    assert (tmp_path / "out" / "a" / "b.txt").read_text() == "ok"
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("../evil.txt", "x")
    with pytest.raises(ValueError, match="escapes"):
        unzip_file_to(str(bad), str(tmp_path / "out2"))
    assert not (tmp_path / "evil.txt").exists()
    tgz = tmp_path / "t.tgz"
    with tarfile.open(tgz, "w:gz") as t:
        data = b"tar ok"
        info = tarfile.TarInfo("c.txt")
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))
    unzip_file_to(str(tgz), str(tmp_path / "out3"))
    assert (tmp_path / "out3" / "c.txt").read_bytes() == b"tar ok"
    with pytest.raises(ValueError, match="Unsupported"):
        unzip_file_to(str(tmp_path / "x.rar"), str(tmp_path))
    assert os.path.isdir(tmp_path / "out")


def test_moving_window_matrix_matches_jax():
    from deeplearning4j_tpu.utils.moving_window import MovingWindowMatrix as JaxMWM
    from deeplearning4j_tpu_torch.utils.moving_window import MovingWindowMatrix
    a = np.arange(48, dtype=np.float32).reshape(6, 8)
    for rows, cols, rot in ((2, 4, False), (3, 3, True), (6, 8, True)):
        got = MovingWindowMatrix(a, rows, cols, add_rotate=rot).windows()
        want = JaxMWM(a, rows, cols, add_rotate=rot).windows()
        assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="exceeds"):
        MovingWindowMatrix(a, 7, 2)
