"""The port's transfer learning (``nn/transferlearning.py``) against the JAX
package's, on the CPU.

Narrow networks are built by the JAX package, carried to the port through
their JSON and ``interop.params_from_jax``; the networks the two builders
make must have equal configurations, and the port's must carry the source
network's retained parameters bitwise. A replaced layer is drawn anew by
each package's own generator, so the JAX network's weights are crossed
into the port's before training. Three steps are then held to the JAX
package's at the training tests' float32 tolerances (loss rtol 1e-5,
parameters and running statistics atol 1e-5); frozen parameters must stay
bitwise unchanged, and frozen batch-norm layers must move their running
statistics as the JAX package's do. The helper's ``featurize`` and
``fit_featurized`` are held the same way, and a frozen prefix must not be
reached by autograd at all.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JaxGraphBuilder
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JaxMerge
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax, state_from_jax)
from deeplearning4j_tpu_torch.nn import transferlearning as ptl
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize import updaters as pupd

LOSS_RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's CPU convolution backward crashes in a process that has run
    XLA:CPU programs; the port's CPU path takes native convolutions here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cross(pnet, jnet):
    """The JAX network's parameters and state into the port's network."""
    return pnet.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                           state_from_jax(_host(jnet.state), device="cpu"))


def _port_mln(jnet):
    return _cross(MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu"),
                  jnet)


def _port_graph(jnet):
    return _cross(ComputationGraph(graph_conf_from_jax_json(jnet.conf.to_json()),
                                   device="cpu"), jnet)


def _same_json(pconf, jconf):
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _close(ptree, jtree, what):
    """Leaf by leaf, by key (JAX sorts dict keys, the port keeps order)."""
    if isinstance(jtree, dict):
        assert sorted(ptree) == sorted(jtree), what
        for k in jtree:
            _close(ptree[k], jtree[k], f"{what}/{k}")
    elif isinstance(jtree, (list, tuple)):
        for i, (p, j) in enumerate(zip(ptree, jtree)):
            _close(p, j, f"{what}/{i}")
    else:
        np.testing.assert_allclose(ptree.detach().numpy(), np.asarray(jtree), atol=ATOL,
                                   err_msg=what)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _data(seed, n=12, n_in=4, classes=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n_in)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _mln_jax():
    conf = (JaxNNC.builder().seed(3).updater(jupd.Adam(learning_rate=0.02))
            .weight_init("xavier").list()
            .layer(JaxDense(n_out=8, activation="relu"))
            .layer(JaxBN())
            .layer(JaxDense(n_out=6, activation="tanh"))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def test_builder_freeze_n_out_replace_fine_tune_trains_as_jax():
    jbase = _mln_jax()
    pbase = _port_mln(jbase)
    jnew = (jtl.TransferLearning.Builder(jbase)
            .fine_tune_configuration(jtl.FineTuneConfiguration(
                updater=jupd.Nesterovs(learning_rate=0.05, momentum=0.9), l2=1e-3, seed=9))
            .set_feature_extractor(1).n_out_replace(2, 5).build())
    pnew = (ptl.TransferLearning.Builder(pbase)
            .fine_tune_configuration(ptl.FineTuneConfiguration(
                updater=pupd.Nesterovs(learning_rate=0.05, momentum=0.9), l2=1e-3, seed=9))
            .set_feature_extractor(1).n_out_replace(2, 5).build())
    _same_json(pnew.conf, jnew.conf)
    assert isinstance(pnew.layers[0].updater, pupd.NoOp) and pnew._frozen == {0, 1}
    for i in (0, 1):  # retained: the source's tensors, copied
        assert _bitwise(pnew.params[i], pbase.params[i])
        assert pnew.params[i]["W" if i == 0 else "gamma"] is not \
            pbase.params[i]["W" if i == 0 else "gamma"]
    assert tuple(pnew.params[2]["W"].shape) == (8, 5)
    assert tuple(pnew.params[3]["W"].shape) == (5, 3)
    _cross(pnew, jnew)
    frozen, stats0 = _clone(pnew.params[:2]), _clone(pnew.state[1])
    for step in range(3):
        x, y = _data(step)
        jnew.fit(JaxDataSet(x, y))
        pnew.fit(DataSet(x, y))
        np.testing.assert_allclose(pnew.score(), float(jnew.score()), rtol=LOSS_RTOL)
    assert _bitwise(pnew.params[:2], frozen)
    # frozen batch norm runs in train mode: its running statistics move
    assert not torch.equal(pnew.state[1]["mean"], stats0["mean"])
    _close(pnew.state, jnew.state, "running statistics")
    _close(pnew.params, jnew.params, "parameters")


def test_builder_remove_output_and_add_layer():
    jbase = _mln_jax()
    pbase = _port_mln(jbase)
    jnew = (jtl.TransferLearning.Builder(jbase).set_feature_extractor(0)
            .remove_output_layer()
            .add_layer(JaxOutput(n_out=2, activation="softmax", loss="mcxent")).build())
    pnew = (ptl.TransferLearning.Builder(pbase).set_feature_extractor(0)
            .remove_output_layer()
            .add_layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent")).build())
    _same_json(pnew.conf, jnew.conf)
    assert all(_bitwise(pnew.params[i], pbase.params[i]) for i in range(3))
    assert tuple(pnew.params[3]["W"].shape) == (6, 2)


def _graph_jax():
    parent = JaxNNC.builder()
    parent.seed(5).updater(jupd.Adam(learning_rate=0.02)).weight_init("xavier")
    conf = (JaxGraphBuilder(parent).add_inputs("in")
            .add_layer("d1", JaxDense(n_out=6, activation="relu"), "in")
            .add_layer("d2", JaxDense(n_out=5, activation="tanh"), "in")
            .add_vertex("merge", JaxMerge(), "d1", "d2")
            .add_layer("out", JaxOutput(n_out=3, activation="softmax", loss="mcxent"),
                       "merge")
            .set_outputs("out").set_input_types(JaxInputType.feed_forward(4)).build())
    return JaxGraph(conf).init()


def test_graph_builder_surgery_trains_as_jax():
    """set_feature_extractor, n_out_replace, remove_vertex_and_connections,
    add_layer, set_outputs and a fine-tune updater on both packages."""
    jbase = _graph_jax()
    pbase = _port_graph(jbase)

    def surgery(tl, base, out_layer, upd):
        return (tl.TransferLearning.GraphBuilder(base)
                .fine_tune_configuration(tl.FineTuneConfiguration(updater=upd))
                .set_feature_extractor("d1").n_out_replace("d2", 7)
                .remove_vertex_and_connections("out")
                .add_layer("out2", out_layer, "merge").set_outputs("out2").build())

    jnew = surgery(jtl, jbase, JaxOutput(n_out=4, activation="softmax", loss="mcxent"),
                   jupd.Sgd(learning_rate=0.1))
    pnew = surgery(ptl, pbase, OutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                   pupd.Sgd(learning_rate=0.1))
    _same_json(pnew.conf, jnew.conf)
    assert pnew._frozen == {"d1"} and _bitwise(pnew.params["d1"], pbase.params["d1"])
    _cross(pnew, jnew)
    d1 = _clone(pnew.params["d1"])
    for step in range(3):
        x, _ = _data(step)
        y = np.eye(4, dtype=np.float32)[np.arange(len(x)) % 4]
        jnew.fit(JaxDataSet(x, y))
        pnew.fit(DataSet(x, y))
        np.testing.assert_allclose(pnew.score(), float(jnew.score()), rtol=LOSS_RTOL)
    assert _bitwise(pnew.params["d1"], d1)
    _close(pnew.params, jnew.params, "parameters")


def test_helper_featurize_and_fit_featurized_match_jax():
    """The two-block conv net split after its stem: the stem's inference
    activations, one fit of the rest on them, folded back."""
    from tests.test_torch_fused_update import conv_batch, port_graph_of, tiny_conv_conf
    jnet = JaxGraph(tiny_conv_conf(jupd.Sgd(learning_rate=0.05))).init()
    pnet = port_graph_of(jnet)
    jh = jtl.TransferLearningHelper(jnet, "stem_act")
    ph = ptl.TransferLearningHelper(pnet, "stem_act")
    x, y = conv_batch(0)
    jf = jh.featurize(x)
    pf = ph.featurize(x)
    assert len(pf) == 1 and pf[0].requires_grad is False
    np.testing.assert_allclose(pf[0].numpy(), jf[0], atol=ATOL)
    jsub = jh.fit_featurized(jf, [y])
    psub = ph.fit_featurized(pf, [torch.from_numpy(y)])
    np.testing.assert_allclose(psub.score(), float(jsub.score()), rtol=LOSS_RTOL)
    assert sorted(psub.conf.network_inputs) == ["stem_act"]
    for n in psub.params:  # folded back into the full graph, bitwise
        assert _bitwise(pnet.params[n], psub.params[n]), n
    _close({n: pnet.params[n] for n in psub.params},
           {n: jnet.params[n] for n in psub.params}, "folded parameters")


def _dense_graph(frozen, device="cpu"):
    """in -> a -> b -> c -> out, dense layers; ``frozen`` ones NoOp."""
    from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    g = GraphBuilder().add_inputs("in")
    prev = "in"
    for name in ("a", "b", "c"):
        g.add_layer(name, DenseLayer(name=name, n_out=5, activation="tanh",
                                     updater=pupd.NoOp() if name in frozen
                                     else pupd.Sgd(learning_rate=0.1)), prev)
        prev = name
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                   updater=pupd.Sgd(learning_rate=0.1)), prev)
    conf = g.set_outputs("out").set_input_types(InputType.feed_forward(4)).build()
    return ComputationGraph(conf, device=device).init()


@pytest.mark.parametrize("frozen,want_calls", [((), {"a", "b", "c"}),
                                               (("a", "b"), {"c"}),
                                               (("b",), {"a", "b", "c"})])
def test_no_gradient_is_asked_for_noop_leaves(monkeypatch, frozen, want_calls):
    """A hook on every dense output counts the backward calls that reach
    it: none reaches a frozen prefix; a frozen layer between trainable ones
    still passes gradients to the layers before it. Frozen leaves get zero
    gradients and stay bitwise as they were."""
    calls = []
    orig = DenseLayer.apply

    def counted(self, params, state, x, **kw):
        out, st = orig(self, params, state, x, **kw)
        if out.requires_grad:
            out.register_hook(lambda g, name=self.name: calls.append(name))
        return out, st

    monkeypatch.setattr(DenseLayer, "apply", counted)
    net = _dense_graph(frozen)
    before = _clone(net.params)
    x, y = _data(1)
    _, grads, _ = net._loss_and_grads([torch.from_numpy(x)], [torch.from_numpy(y)])
    assert set(calls) == want_calls
    for name in frozen:
        assert all(not torch.any(g) for g in tree_leaves(grads[name]))
    net.fit(DataSet(x, y))
    for name in ("a", "b", "c"):
        assert _bitwise(net.params[name], before[name]) == (name in frozen), name
