"""Sequence ComputationGraphs of the PyTorch port against the JAX package,
on the CPU: features masks through the DAG, ``LastTimeStepVertex`` and
``DuplicateToTimeSeriesVertex``, truncated BPTT (one input and two) and
``rnn_time_step``, plus the listener hooks of ``fit``.

Graphs are the JAX package's own test graphs (``tests/test_graph.py``:
``test_seq2seq_style_graph``, ``_rnn_graph``, ``test_graph_tbptt_multi_input``)
built by the JAX package and carried to the port through their JSON;
weights cross with ``interop.params_from_jax``; inputs and masks come from
numpy with fixed seeds (masks: one full row, the others ending early, one
of them inside the first tBPTT window).

Tolerances (float32): outputs and losses rtol 1e-5 / atol 1e-6, gradients
and trained parameters atol 1e-5 (torch and XLA sum the products in other
orders, and the recurrence carries the difference through every step).
``LastTimeStepVertex`` is a gather: bitwise. The port's graph against the
port's MultiLayerNetwork on the same weights runs the same operations:
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax)
from deeplearning4j_tpu_torch.nn.conf.graph import LastTimeStepVertex
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _mask(batch, t, lengths):
    m = np.zeros((batch, t), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
    return m


def _pair(jconf):
    jnet = JaxGraph(jconf).init()
    net = ComputationGraph(graph_conf_from_jax_json(jconf.to_json()), device="cpu")
    net.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                   params_from_jax(_host(jnet.state), device="cpu"))
    return jnet, net


def _assert_params_close(net, jnet, atol=1e-5):
    for name, jp in _host(jnet.params).items():
        for k, v in jp.items():
            np.testing.assert_allclose(net.params[name][k].detach().numpy(), v, rtol=0,
                                       atol=atol, err_msg=f"{name}/{k}")


def test_last_time_step_vertex_takes_the_last_unmasked_step():
    """Each row's last unmasked step (step 0 for a row with none), as the
    JAX vertex gathers it; the last step without a mask."""
    x = np.random.default_rng(0).standard_normal((4, 6, 3)).astype(np.float32)
    m = _mask(4, 6, (6, 3, 1, 0))
    jv, pv = jgraph.LastTimeStepVertex(), LastTimeStepVertex()
    got = pv.apply(_t(x), mask=_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jv.apply(jnp.asarray(x),
                                                           mask=jnp.asarray(m))))
    np.testing.assert_array_equal(got, x[[0, 1, 2, 3], [5, 2, 0, 0]])
    np.testing.assert_array_equal(pv.apply(_t(x)).numpy(), x[:, -1])


def _seq2seq(mask_input=None):
    parent = JaxNNC.builder().seed(4).updater(jupd.Adam(0.01)).weight_init("xavier")
    return (jgraph.GraphBuilder(parent)
            .add_inputs("seq")
            .add_layer("enc", jrec.LSTM(n_out=8, activation="tanh"), "seq")
            .add_vertex("last", jgraph.LastTimeStepVertex(mask_input=mask_input), "enc")
            .add_vertex("dup", jgraph.DuplicateToTimeSeriesVertex(reference_input="seq"),
                        "last")
            .add_layer("dec", jrec.LSTM(n_out=8, activation="tanh"), "dup")
            .add_layer("out", jrec.RnnOutputLayer(n_out=3, loss="mcxent"), "dec")
            .set_outputs("out")
            .set_input_types(JaxInputType.recurrent(5))
            .build())


@pytest.mark.parametrize("case", ["unmasked", "masked", "mask_input"])
def test_seq2seq_graph_output_loss_and_gradients_match_jax(case):
    """LastTimeStep + DuplicateToTimeSeries: outputs, the loss (scored over
    the mask that reaches the output) and every gradient."""
    jnet, net = _pair(_seq2seq("seq" if case == "mask_input" else None))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 7))]
    m = None if case == "unmasked" else _mask(3, 7, (7, 4, 2))
    fm = None if m is None else [m]
    want = jnet.output_single(x, features_masks=fm)
    got = net.output_single(x, features_masks=fm)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jm = None if m is None else [jnp.asarray(m)]
    (jloss, _), jgrads = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)], None, jm, None)
    loss, grads, _ = net._loss_and_grads([_t(x)], [_t(y)], None,
                                         None if m is None else [_t(m)], None)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert net.score_dataset(MultiDataSet([x], [y], fm)) == pytest.approx(
        jnet.score_dataset(JaxMultiDataSet([x], [y], fm)), rel=1e-5)
    for name, jg in _host(jgrads).items():
        for k, v in jg.items():
            np.testing.assert_allclose(grads[name][k].numpy(), v, rtol=0, atol=1e-5,
                                       err_msg=f"{name}/{k}")


def _rnn_graph(tbptt=None):
    """tests/test_graph.py::_rnn_graph: LSTM(12) -> RnnOutputLayer(4), Adam."""
    parent = JaxNNC.builder().seed(6).updater(jupd.Adam(5e-3)).weight_init("xavier")
    g = jgraph.GraphBuilder(parent)
    g.add_inputs("in")
    g.add_layer("lstm", jrec.LSTM(n_out=12, activation="tanh"), "in")
    g.add_layer("out", jrec.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                "lstm")
    g.set_outputs("out")
    g.set_input_types(JaxInputType.recurrent(4))
    if tbptt:
        g.backprop_type("tbptt", fwd_length=tbptt)
    return g.build()


def _onehot_seq(batch, t, seed):
    rng = np.random.default_rng(seed)
    x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (batch, t))]
    return x, np.roll(x, -1, axis=1)


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_graph_tbptt_fit_matches_jax(masked):
    """Windows of 5 over 13 steps (the last ragged), two fits, masks sliced
    per window (one row ends inside the first window)."""
    jnet, net = _pair(_rnn_graph(tbptt=5))
    x, y = _onehot_seq(4, 13, seed=7)
    fm = [_mask(4, 13, (13, 9, 3, 6))] if masked else None
    for _ in range(2):
        jnet.fit(JaxMultiDataSet([x], [y], fm))
        net.fit(MultiDataSet([x], [y], fm))
    assert net.iteration == jnet.iteration == 6
    assert net.score() == pytest.approx(float(jnet.score()), rel=1e-5)
    _assert_params_close(net, jnet)


def test_multi_input_tbptt_graph_matches_jax():
    """Two sequence inputs (each with its own mask) merged before the LSTM
    window together; 12 steps at 4 a window."""
    parent = JaxNNC.builder().seed(3).updater(jupd.Adam(5e-3)).weight_init("xavier")
    g = jgraph.GraphBuilder(parent)
    g.add_inputs("a", "b")
    g.add_vertex("merge", jgraph.MergeVertex(), "a", "b")
    g.add_layer("lstm", jrec.LSTM(n_out=8, activation="tanh"), "merge")
    g.add_layer("out", jrec.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                "lstm")
    g.set_outputs("out")
    g.set_input_types(JaxInputType.recurrent(2), JaxInputType.recurrent(3))
    g.backprop_type("tbptt", fwd_length=4)
    jnet, net = _pair(g.build())
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 12, 2)).astype(np.float32)
    b = rng.standard_normal((4, 12, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 12))]
    fm = [_mask(4, 12, (12, 7, 5, 10)), None]
    jnet.fit(JaxMultiDataSet([a, b], [y], fm))
    net.fit(MultiDataSet([a, b], [y], fm))
    assert net.iteration == jnet.iteration == 3
    assert net.score() == pytest.approx(float(jnet.score()), rel=1e-5)
    _assert_params_close(net, jnet)


def test_graph_rnn_time_step_matches_full_forward_and_jax():
    jnet, net = _pair(_rnn_graph())
    x = np.random.default_rng(5).standard_normal((2, 6, 4)).astype(np.float32)
    full = net.output_single(x)
    steps = [net.rnn_time_step(x[:, t])[0] for t in range(4)]
    rest = net.rnn_time_step(x[:, 4:])[0]  # a 2-step sequence call
    got = np.concatenate([np.stack(steps, axis=1), rest], axis=1)
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-6)
    jsteps = [jnet.rnn_time_step(x[:, t])[0] for t in range(4)]
    np.testing.assert_allclose(np.stack(steps, axis=1), np.stack(jsteps, axis=1),
                               rtol=1e-5, atol=1e-6)
    assert net.rnn_get_previous_state() is not None
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(x[:1, 0])
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state() is None


class _Recorder:
    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch):
        self.calls.append(("iteration", iteration, epoch))

    def on_epoch_start(self, model):
        self.calls.append(("start", model.epoch))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.epoch))


@pytest.mark.parametrize("masked", [False, True])
def test_graph_tbptt_equals_multilayer_bitwise(masked):
    """The graph and the MultiLayerNetwork of the same layers, on the same
    weights and masked data, take the same windows to the same parameters,
    bitwise; both call the listeners the same way (once a window, and at
    each epoch's start and end)."""
    jconf = _rnn_graph(tbptt=5)
    _, graph = _pair(jconf)
    mconf = (JaxNNC.builder().seed(6).updater(jupd.Adam(5e-3)).weight_init("xavier").list()
             .layer(jrec.LSTM(n_out=12, activation="tanh"))
             .layer(jrec.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"))
             .set_input_type(JaxInputType.recurrent(4))
             .backprop_type("tbptt", fwd_length=5, back_length=5).build())
    mln = MultiLayerNetwork(conf_from_jax_json(mconf.to_json()), device="cpu")
    mln.set_params([{k: v.clone() for k, v in graph.params[n].items()}
                    for n in ("lstm", "out")])
    x, y = _onehot_seq(4, 13, seed=8)
    fm = _mask(4, 13, (13, 11, 4, 8)) if masked else None
    recs = _Recorder(), _Recorder()
    graph.set_listeners(recs[0])
    mln.add_listener(recs[1])
    graph.fit(DataSet(x, y, features_mask=fm), num_epochs=2)
    mln.fit(DataSet(x, y, features_mask=fm), num_epochs=2)
    assert recs[0].calls == recs[1].calls
    assert recs[0].calls[:5] == [("start", 0), ("iteration", 0, 0), ("iteration", 1, 0),
                                 ("iteration", 2, 0), ("end", 0)]
    for i, n in enumerate(("lstm", "out")):
        for k, v in graph.params[n].items():
            assert torch.equal(v, mln.params[i][k]), f"{n}/{k}"
