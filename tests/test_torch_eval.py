"""The port's evaluation classes on the CPU against the JAX package's, on
the same arrays: integer counts exact, float statistics within 1e-12 (both
compute them in float64 from the same counts and pairs). Inputs are numpy
arrays and CPU tensors; the curves' JSON is read both ways, and the port's
``Evaluation`` / ``ConfusionMatrix`` / ``ROC`` JSON round-trips and reads
a JAX object's state (the JAX classes have no ``to_json`` of their own).
``evaluate`` / ``evaluate_regression`` of both networks on the same
weights give the JAX package's counts and statistics.

Inputs come from numpy with fixed seeds.
"""

import json

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.eval as jev
import deeplearning4j_tpu_torch.eval as pev
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.eval.curves import BaseCurve as JCurve
from deeplearning4j_tpu.eval.evaluation import ConfusionMatrix as JCM
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf.convolutional import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JGraphBuilder
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.conf.network import Builder as JBuilder
from deeplearning4j_tpu.nn.conf.pooling import GlobalPoolingLayer as JGlobalPooling
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.eval.curves import BaseCurve as PCurve
from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix as PCM
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax, state_from_jax)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes in a process
    that has run XLA:CPU programs (see tests/test_torch_training.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _probs(rng, shape):
    z = rng.standard_normal(shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _batches(seed, n_batches=3, n=20, k=4, time=None, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        shape = (n, k) if time is None else (n, time, k)
        y = np.eye(k, dtype=np.float32)[rng.integers(0, k, shape[:-1])]
        p = _probs(rng, shape)
        m = (rng.random(shape[:-1]) > 0.25).astype(np.float32) if mask else None
        out.append((y, p, m))
    return out


def _feed(obj, batches, tensors):
    for y, p, m in batches:
        if tensors:
            y, p = torch.from_numpy(y), torch.from_numpy(p)
            m = None if m is None else torch.from_numpy(m)
        obj.eval(y, p, mask=m)
    return obj


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **TOL)


@pytest.mark.parametrize("top_n", [1, 3])
@pytest.mark.parametrize("shape", ["flat", "flat_mask", "time_mask"])
@pytest.mark.parametrize("tensors", ["numpy", "tensor", "device_path"])
def test_evaluation_matches_jax(top_n, shape, tensors, monkeypatch):
    """``device_path`` runs the card's accumulation (bincount, top-k and
    masks on tensors, one read at the end) on CPU tensors."""
    if tensors == "device_path":
        import deeplearning4j_tpu_torch.eval.evaluation as pevaluation
        monkeypatch.setattr(pevaluation, "_on_card", lambda *a: torch.device("cpu"))
    tensors = tensors != "numpy"
    batches = _batches(1, time=5 if shape == "time_mask" else None,
                       mask=shape != "flat")
    labels = ["a", "b", "c", "d"]
    je = _feed(jev.Evaluation(labels=labels, top_n=top_n), batches, False)
    pe = _feed(pev.Evaluation(labels=labels, top_n=top_n), batches, tensors)
    assert np.array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert pe.confusion.get_count(1, 2) == je.confusion.get_count(1, 2)
    for f in ("accuracy", "precision", "recall", "f1", "top_n_accuracy"):
        _close(getattr(pe, f)(), getattr(je, f)())
    for c in range(4):
        for f in ("precision", "recall", "f1", "false_positive_rate"):
            _close(getattr(pe, f)(c), getattr(je, f)(c))
    assert pe.stats() == je.stats()
    # merge: two halves equal the whole, as in the JAX package
    jm = _feed(jev.Evaluation(top_n=top_n), batches[:1], False).merge(
        _feed(jev.Evaluation(top_n=top_n), batches[1:], False))
    pm = _feed(pev.Evaluation(top_n=top_n), batches[:1], tensors).merge(
        _feed(pev.Evaluation(top_n=top_n), batches[1:], tensors))
    assert np.array_equal(pm.confusion.matrix, jm.confusion.matrix)
    _close(pm.top_n_accuracy(), jm.top_n_accuracy())


def test_evaluation_and_confusion_json():
    batches = _batches(2, mask=True)
    je = _feed(jev.Evaluation(labels=list("wxyz"), top_n=2), batches, False)
    pe = _feed(pev.Evaluation(labels=list("wxyz"), top_n=2), batches, False)
    back = pev.Evaluation.from_json(pe.to_json())
    assert back.stats() == je.stats() and back.top_n_accuracy() == je.top_n_accuracy()
    # the JAX object's state, read by the port
    jstate = json.dumps({"n_classes": je.n_classes, "labels": je.label_names,
                         "top_n": je.top_n, "top_n_correct": je._top_n_correct,
                         "top_n_total": je._top_n_total,
                         "confusion": je.confusion.matrix.tolist()})
    assert pev.Evaluation.from_json(jstate).to_json() == pe.to_json()
    jcm = JCM(3)
    jcm.add(np.array([0, 1, 2, 2]), np.array([0, 2, 2, 1]))
    pcm = PCM.from_json(json.dumps({"matrix": jcm.matrix.tolist()}))
    assert np.array_equal(pcm.matrix, jcm.matrix)
    assert np.array_equal(PCM.from_json(pcm.to_json()).matrix, jcm.matrix)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
def test_evaluation_binary_matches_jax(mask, tensors):
    rng = np.random.default_rng(3)
    batches = [((rng.random((15, 5)) > 0.5).astype(np.float32),
                rng.random((15, 5)).astype(np.float32),
                (rng.random(15) > 0.3).astype(np.float32) if mask else None)
               for _ in range(3)]
    je = _feed(jev.EvaluationBinary(threshold=0.4), batches, False)
    pe = _feed(pev.EvaluationBinary(threshold=0.4), batches, tensors)
    for f in ("tp", "fp", "tn", "fn"):
        assert np.array_equal(getattr(pe, f), getattr(je, f))
    for i in range(5):
        for f in ("accuracy", "precision", "recall", "f1"):
            _close(getattr(pe, f)(i), getattr(je, f)(i))
    pm = _feed(pev.EvaluationBinary(0.4), batches[:2], tensors).merge(
        _feed(pev.EvaluationBinary(0.4), batches[2:], tensors))
    assert np.array_equal(pm.tp, je.tp) and np.array_equal(pm.fn, je.fn)


def _binary_batches(seed, ties=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        s = rng.random(25)
        if ties:
            s = np.round(s, 1)
        y = (rng.random(25) < s).astype(np.float32)
        out.append((y, s.astype(np.float32), (rng.random(25) > 0.2).astype(np.float32)))
    return out


@pytest.mark.parametrize("steps", [0, 20])
@pytest.mark.parametrize("ties", [False, True])
def test_roc_matches_jax(steps, ties):
    batches = _binary_batches(4, ties)
    jr = _feed(jev.ROC(steps), batches, False)
    pr = _feed(pev.ROC(steps), batches, True)
    _close(pr.calculate_auc(), jr.calculate_auc())
    _close(pr.calculate_auprc(), jr.calculate_auprc())
    for a, b in zip(pr.get_roc_curve(11), jr.get_roc_curve(11)):
        _close(a, b)
    back = pev.ROC.from_json(pr.to_json())
    _close(back.calculate_auc(), jr.calculate_auc())
    # exported curves: the JSON of either package read by the other
    for export in ("export_roc_curve", "export_precision_recall_curve"):
        jc, pc = getattr(jr, export)(21), getattr(pr, export)(21)
        assert pc.to_json() == jc.to_json()
        assert PCurve.from_json(jc.to_json()).to_json() == jc.to_json()
        assert JCurve.from_json(pc.to_json()).to_json() == pc.to_json()


@pytest.mark.parametrize("kind", ["multiclass", "binary", "binary_thresholded"])
def test_multi_output_rocs_match_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "multiclass":
        batches = _batches(5, mask=True)
        make = {"j": jev.ROCMultiClass, "p": pev.ROCMultiClass}
    else:
        steps = 0 if kind == "binary" else 16
        batches = [((rng.random((12, 3)) > 0.5).astype(np.float32),
                    rng.random((12, 3)).astype(np.float32),
                    (rng.random(12) > 0.2).astype(np.float32)) for _ in range(3)]
        make = {"j": lambda: jev.ROCBinary(steps), "p": lambda: pev.ROCBinary(steps)}
    jr = _feed(make["j"](), batches, False)
    pr = _feed(make["p"](), batches, True)
    n = 4 if kind == "multiclass" else 3
    for i in range(n):
        _close(pr.calculate_auc(i), jr.calculate_auc(i))
    _close(pr.calculate_average_auc(), jr.calculate_average_auc())
    pm = _feed(make["p"](), batches[:1], False).merge(_feed(make["p"](), batches[1:], False))
    _close(pm.calculate_average_auc(), jr.calculate_average_auc())


@pytest.mark.parametrize("mask", [False, True])
def test_regression_evaluation_matches_jax(mask):
    rng = np.random.default_rng(6)
    batches = [(rng.standard_normal((10, 3)).astype(np.float32),
                rng.standard_normal((10, 3)).astype(np.float32),
                (rng.random(10) > 0.3).astype(np.float32) if mask else None)
               for _ in range(3)]
    je = _feed(jev.RegressionEvaluation(), batches, False)
    pe = _feed(pev.RegressionEvaluation(), batches, True)
    assert pe.n == je.n
    for c in range(3):
        for f in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                  "relative_squared_error", "pearson_correlation", "r_squared"):
            _close(getattr(pe, f)(c), getattr(je, f)(c))
    _close(pe.average_mean_squared_error(), je.average_mean_squared_error())
    assert pe.stats() == je.stats()
    pm = _feed(pev.RegressionEvaluation(), batches[:1], False).merge(
        _feed(pev.RegressionEvaluation(), batches[1:], False))
    _close(pm.average_mean_squared_error(), je.average_mean_squared_error())


def test_calibration_matches_jax():
    batches = _batches(7, mask=True)
    je = _feed(jev.EvaluationCalibration(8, 12), batches, False)
    pe = _feed(pev.EvaluationCalibration(8, 12), batches, True)
    for c in range(4):
        for f in ("get_reliability_diagram", "get_residual_plot", "get_probability_histogram"):
            assert getattr(pe, f)(c).to_json() == getattr(je, f)(c).to_json()
            assert JCurve.from_json(getattr(pe, f)(c).to_json()).to_json() == \
                getattr(je, f)(c).to_json()
        assert pe.get_probability_histogram(c, positive_only=True).to_json() == \
            je.get_probability_histogram(c, positive_only=True).to_json()
        _close(pe.expected_calibration_error(c), je.expected_calibration_error(c))


def _mln_pair(regression=False):
    out = (JOutput(n_out=2, activation="identity", loss="mse") if regression
           else JOutput(n_out=3, activation="softmax", loss="mcxent"))
    jconf = (JBuilder().seed(9).weight_init("xavier").list()
             .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
             .layer(JDense(n_out=8, activation="tanh")).layer(out)
             .set_input_type(JInputType.convolutional(6, 6, 2)).build())
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    pnet.set_params(params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                     for p in jnet.params], device="cpu"))
    return jnet, pnet


def _image_batches(seed, k, regression=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.standard_normal((9, 6, 6, 2)).astype(np.float32)
        y = (rng.standard_normal((9, k)).astype(np.float32) if regression
             else np.eye(k, dtype=np.float32)[rng.integers(0, k, 9)])
        out.append((x, y))
    return out


def test_multilayer_evaluate_and_evaluate_regression_match_jax():
    jnet, pnet = _mln_pair()
    data = _image_batches(10, 3)
    je = jnet.evaluate([JDataSet(x, y) for x, y in data])
    pe = pnet.evaluate([DataSet(x, y) for x, y in data])
    assert np.array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert pe.confusion.matrix.sum() == 27
    jnet, pnet = _mln_pair(regression=True)
    data = _image_batches(11, 2, regression=True)
    je = jnet.evaluate_regression([JDataSet(x, y) for x, y in data])
    pe = pnet.evaluate_regression([DataSet(x, y) for x, y in data])
    for c in range(2):
        # the forward itself differs by float32 rounding between torch and XLA
        np.testing.assert_allclose(pe.mean_squared_error(c), je.mean_squared_error(c),
                                   rtol=1e-5)


def test_graph_evaluate_matches_jax():
    g = JGraphBuilder(JBuilder().seed(9).weight_init("xavier"))
    g.add_inputs("in")
    g.add_layer("conv", JConv(n_out=4, kernel_size=(3, 3), activation="relu"), "in")
    g.add_layer("pool", JGlobalPooling(pooling_type="avg"), "conv")
    g.add_layer("out", JOutput(n_out=3, activation="softmax", loss="mcxent"), "pool")
    g.set_outputs("out")
    g.set_input_types(JInputType.convolutional(8, 8, 3))
    jnet = JGraph(g.build()).init()
    pnet = ComputationGraph(graph_conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    host = jax.tree_util.tree_map(np.asarray, (jnet.params, jnet.state))
    pnet.set_params(params_from_jax(host[0], device="cpu"), state_from_jax(host[1], device="cpu"))
    rng = np.random.default_rng(12)
    data = [(rng.standard_normal((5, 8, 8, 3)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]) for _ in range(2)]
    je = jnet.evaluate([JDataSet(x, y) for x, y in data])
    pe = pnet.evaluate([DataSet(x, y) for x, y in data])
    assert np.array_equal(pe.confusion.matrix, je.confusion.matrix)
