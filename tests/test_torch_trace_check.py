"""The port's ``analysis.trace_check`` against the JAX package's, on the
CPU: the report's shape and counters are the JAX package's; a
``float(loss)`` is a sync point named by its file:line, a ragged batch
through ``fit`` is a shape drift of ``train``, and a tensor held in a
watched function's closure is a captured constant (at least
``const_min_bytes``, 4,096 as in the JAX package). The CPU has no device
to wait for, so these tests watch CPU tensors (``sync_devices=("cpu",)``);
the default watches CUDA tensors only."""

import importlib
import inspect

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import TraceReport, trace_check
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.stats import TrainingStats
from deeplearning4j_tpu_torch.perf.compile_watch import CompileWatch

# the JAX package's analysis/__init__ exports a class named like this module
jtc = importlib.import_module("deeplearning4j_tpu.analysis.trace_check")


def _net():
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_out=4, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _ds(rows, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.standard_normal((rows, 3)).astype(np.float32),
                   np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)])


def test_report_shape_and_counters_are_the_jax_packages():
    assert TraceReport().counts() == jtc.TraceReport().counts()
    assert TraceReport().summary() == jtc.TraceReport().summary()
    assert set(inspect.signature(trace_check).parameters) >= set(
        inspect.signature(jtc.trace_check).parameters)


def test_sync_drift_and_captured_constant_in_one_region():
    net = _net()
    stats = TrainingStats()
    watch = CompileWatch("user")
    big, small = torch.ones(64, 64), torch.ones(4)
    scaled = watch.wrap(lambda x: x @ big + small.sum(), "scaled")
    patched = torch.Tensor.__float__
    with trace_check(model=net, stats=stats, sync_devices=("cpu",)) as report:
        for rows in (8, 8, 5):
            net.fit(_ds(rows, rows))
        loss = net._score
        line = inspect.currentframe().f_lineno + 1
        value = float(loss)
        scaled(torch.zeros(2, 64))
        scaled(torch.zeros(2, 64))
    assert torch.Tensor.__float__ is patched  # restored on exit
    assert np.isfinite(value)
    syncs = [h for h in report.sync_points if h.where.endswith(f"test_torch_trace_check.py:{line}")]
    assert len(syncs) == 1 and "Tensor.__float__" in syncs[0].detail
    assert [(h.where, h.count) for h in report.recompiles] == [("train", 2)]
    consts = report.captured_constants
    assert [h.where for h in consts] == ["scaled"] and "(64, 64)" in consts[0].detail
    counts = report.counts()
    assert counts["trace_recompiles"] == 2 and counts["trace_captured_consts"] == 1
    assert counts["trace_sync_points"] >= 1
    assert net.last_trace_report is report
    assert {k: stats.counters[k] for k in counts} == counts
    assert "finding(s)" in report.summary()


def test_card_tensors_only_by_default_and_no_nesting():
    with trace_check() as report:
        float(torch.ones(()))
        bool(torch.ones(()) > 0)
        torch.ones(3).tolist()
    assert report.sync_points == [] and report.summary() == "trace_check: no hazards detected"
    with trace_check():
        with pytest.raises(RuntimeError, match="cannot nest"):
            with trace_check():
                pass


def test_parallel_inference_reports_the_models_hazards():
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    net = _net()
    with trace_check(model=net, sync_devices=("cpu",)):
        net.fit(_ds(4))
        net.fit(_ds(6))
    pi = ParallelInference(net, inference_mode="sequential", device="cpu")
    try:
        assert pi.stats()["trace_hazards"]["trace_recompiles"] == 2
    finally:
        pi.shutdown()
