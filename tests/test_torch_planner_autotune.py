"""The port's memory planner and autotuner (``perf/planner.py``,
``perf/autotune.py``), its saved-set measurement
(``perf/fusion.py::training_activation_bytes``) and the TuningRecord
through zips, shard sets, ``fit`` and serving, against the JAX package, on
the CPU.

- ``conf_signature`` is equal for LeNet, ResNet50 and the char-RNN, each
  as built and fused; a ``TuningRecord``'s JSON is byte-equal across the
  packages in both directions; ``apply_tuning`` gives the same JSON.
- ``plan_memory`` chooses the same fusion, remat and candidate count as
  the JAX planner on a small CNN and a small graph at four budgets (loose,
  mid, all-remat, infeasible), both packages' measurement monkeypatched to
  one table. That table is a function of each package's analytic memory
  report (equal across the packages), so parity rests on the search alone,
  not on the two measurements.
- ``training_activation_bytes``: fused < unfused and remat < none in both
  packages; on a small BN CNN the port's value is within [0.5, 2] of the
  JAX package's. The port counts parameters, inputs and labels the
  backward keeps (its definition: every saved tensor); the JAX package's
  jaxpr route leaves forwarded inputs out, and saves some activations the
  port recomputes, so the two differ by 0.74–1.19 on this net. The JAX
  package's measurement looks for a ``pjit`` equation, which this JAX
  version names ``jit``; the JAX side runs with ``_residual_bytes_of``
  patched (in this test only) to accept either name.
- Zips and shard sets carrying a record cross both ways; a stale record is
  refused by ``ParallelInference`` and ``ModelServer``; ``fit`` re-slices
  a caller's iterator to the record's batch size as the JAX ``fit`` does
  (same parameters after an epoch, rtol 1e-5); a tiny ``autotune`` on LeNet
  returns a valid record.
"""

import dataclasses
import importlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.models as jm
import deeplearning4j_tpu.perf.fusion as jfusion
from deeplearning4j_tpu.checkpoint import sharded as jshd
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import memory as jmem
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import layers as jlay
from deeplearning4j_tpu.nn.conf import normalization as jnorm
from deeplearning4j_tpu.nn.conf.pooling import GlobalPoolingLayer as JGlobalPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.utils import serialization as jser

import deeplearning4j_tpu_torch.models as pm
import deeplearning4j_tpu_torch.perf.fusion as pfusion
from deeplearning4j_tpu_torch.checkpoint import sharded as pshd
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, graph_conf_from_jax_json,
                                              params_from_jax, state_from_jax)
from deeplearning4j_tpu_torch.nn import memory as pmem
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.perf import autotune as pauto
from deeplearning4j_tpu_torch.perf import planner as pplan
from deeplearning4j_tpu_torch.utils import serialization as pser

# the JAX package's perf/__init__ exports functions named like these modules
jauto = importlib.import_module("deeplearning4j_tpu.perf.autotune")
jplan = importlib.import_module("deeplearning4j_tpu.perf.planner")
SIDE, CLASSES = 8, 3


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's CPU convolution backward crashes in a process that has run
    XLA:CPU programs; the port's CPU path takes native convolutions here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_conf(jconf):
    return (conf_from_jax_json if hasattr(jconf, "layers") else
            graph_conf_from_jax_json)(jconf.to_json())


def _bn_cnn(blocks=2, n_out=16, side=16):
    """``blocks`` x conv(3x3)-BN-relu, global average pooling, softmax."""
    b = JNNC.builder().seed(5).updater(jupd.Sgd(learning_rate=0.05)).list()
    for _ in range(blocks):
        b = (b.layer(jconv.ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                            convolution_mode="same", activation="identity"))
             .layer(jnorm.BatchNormalization()).layer(jlay.ActivationLayer(activation="relu")))
    return (b.layer(JGlobalPool(pooling_type="avg"))
            .layer(jlay.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.convolutional(side, side, 3)).build())


def _mlp():
    return (JNNC.builder().seed(9).updater(jupd.Sgd(learning_rate=0.1)).list()
            .layer(jlay.DenseLayer(n_out=6, activation="tanh"))
            .layer(jlay.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(5)).build())


def _record(mod, conf, **kw):
    sig = mod.conf_signature(conf)
    fields = dict(model_type=type(conf).__name__, dtype=conf.dtype, signature=sig,
                  tuned_signature=sig, batch_size=8, fusion=False, donate=True, remat={},
                  buckets=(8, 16), objective={"step_seconds": 0.25}, baseline={},
                  candidates_searched=2)
    fields.update(kw)
    return mod.TuningRecord(**fields)


# ------------------------------------------------------- signatures, records
def _zoo_confs():
    from tests.test_torch_fused_update import tiny_conv_conf
    return {"lenet": jm.LeNet().conf(),
            "resnet50": jm.ResNet50(num_classes=10, input_shape=(32, 32, 3)).conf(),
            "char_rnn": jm.TextGenerationLSTM().conf(),
            "tiny_graph": tiny_conv_conf(jupd.Sgd(learning_rate=0.1))}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["lenet", "resnet50", "char_rnn"])
def test_conf_signature_equal(name, fused):
    jconf = _zoo_confs()[name]
    if fused:
        jconf = jfusion.fuse(jconf)
    pconf = _port_conf(jconf)
    assert pauto.conf_signature(pconf) == jauto.conf_signature(jconf)


def test_tuning_record_json_byte_equal_both_ways():
    jconf = jfusion.fuse(_bn_cnn())
    jrec = _record(jauto, _bn_cnn(), tuned_signature=jauto.conf_signature(jconf),
                   fusion=True, remat={"layer1": "nothing_saveable"}, budget_bytes=123456,
                   pallas_kernels=True,
                   baseline={"bytes_accessed": 1.5e6, "flops": 2e6,
                             "estimate_per_example": 3.25})
    prec = pauto.TuningRecord.from_json(jrec.to_json())
    assert prec.to_json() == jrec.to_json()
    assert jauto.TuningRecord.from_json(prec.to_json()).to_json() == prec.to_json()
    assert pauto.TUNING_FORMAT_VERSION == jauto.TUNING_FORMAT_VERSION


def test_apply_tuning_same_json_and_the_kernel_arm():
    jconf = _bn_cnn()
    pconf = _port_conf(jconf)
    tuned_sig = jauto.conf_signature(jfusion.fuse(jconf))
    jrec = _record(jauto, jconf, tuned_signature=tuned_sig, fusion=True,
                   remat={"layer1": "nothing_saveable", "layer2": "full"})
    prec = pauto.TuningRecord.from_dict(jrec.to_dict())
    jt = jauto.apply_tuning(jconf, jrec)
    pt = pauto.apply_tuning(pconf, prec, device="cpu")
    assert pt.to_json() == jt.to_json()
    # already in the tuned layout: not fused again, same result
    assert pauto.apply_tuning(pt, prec, device="cpu").to_json() == jt.to_json()
    stale = _record(pauto, _port_conf(_mlp()))
    with pytest.raises(pauto.StaleTuningRecordError):
        pauto.apply_tuning(pconf, stale, device="cpu")
    off = dataclasses.replace(prec, pallas_kernels=False)
    assert pauto.apply_tuning(pconf, off, device="cpu").to_json() == jt.to_json()
    from deeplearning4j_tpu_torch.perf.kernels import KernelSelectionError
    with pytest.raises(KernelSelectionError):
        pauto.apply_tuning(pconf, off, device="cuda")


# ------------------------------------------------------------------ planner
def _table(report_fn):
    """A saved-bytes measure from a package's analytic report: twice the
    activations of every layer that keeps them, an eighth of a rematted
    layer's, plus a constant."""
    def measure(conf, minibatch=32, augmentation=None):
        rows = report_fn(conf, minibatch=minibatch, training_bytes=False).layers
        return int(4096 + sum(r.activation_bytes_per_example * minibatch
                              * (2.0 if r.remat is None else 0.125) for r in rows))
    return measure


@pytest.mark.parametrize("which", ["cnn", "graph"])
def test_plan_memory_chooses_the_jax_plan(monkeypatch, which):
    jconf = _bn_cnn(blocks=3) if which == "cnn" else _zoo_confs()["tiny_graph"]
    pconf = _port_conf(jconf)
    jmeasure, pmeasure = _table(jmem.conf_memory_report), _table(pmem.conf_memory_report)
    monkeypatch.setattr(jfusion, "training_activation_bytes", jmeasure)
    monkeypatch.setattr(pfusion, "training_activation_bytes", pmeasure)
    mb = 4
    rep = jmem.conf_memory_report(jconf, minibatch=mb, training_bytes=False)
    fixed = rep.total_param_bytes + rep.updater_state_bytes
    fused = jfusion.fuse(jconf)
    base = jmeasure(fused, mb)
    rematable = {i: "nothing_saveable" for k, l, i in jplan._layer_entries(fused)
                 if jplan._rematable(k, l, fused)}
    floor = jmeasure(jplan._with_remat(fused, rematable), mb)
    assert floor < base
    for budget in (fixed + base, fixed + (base + floor) // 2, fixed + floor):
        jp = jplan.plan_memory(jconf, budget, minibatch=mb)
        pp = pplan.plan_memory(pconf, budget, minibatch=mb)
        for f in ("fused", "remat", "candidates_evaluated", "baseline_activation_bytes",
                  "predicted_activation_bytes", "measured_activation_bytes", "fixed_bytes"):
            assert getattr(pp, f) == getattr(jp, f), (budget, f)
        assert pp.conf.to_json() == jp.conf.to_json()
        assert pp.kernels == {k: "cuda" for k in jp.kernels}
        jv = jplan.plan_memory(jconf, budget, minibatch=mb, verify=False)
        pv = pplan.plan_memory(pconf, budget, minibatch=mb, verify=False)
        assert (pv.remat, pv.candidates_evaluated) == (jv.remat, jv.candidates_evaluated)
    with pytest.raises(jplan.BudgetInfeasibleError) as je:
        jplan.plan_memory(jconf, fixed + floor - 1, minibatch=mb)
    with pytest.raises(pplan.BudgetInfeasibleError) as pe:
        pplan.plan_memory(pconf, fixed + floor - 1, minibatch=mb)
    assert pe.value.best_plan.remat == je.value.best_plan.remat
    with pytest.raises(pplan.BudgetInfeasibleError):
        pplan.plan_memory(pconf, fixed, minibatch=mb)


def _jax_residual_bytes(run, *structs):
    """The JAX package's ``_residual_bytes_of`` reading the first ``jit``
    (or ``pjit``) equation: this JAX version's name for it."""
    jaxpr = jax.make_jaxpr(run)(*structs)
    fwd = next(e for e in jaxpr.eqns if e.primitive.name in ("pjit", "jit"))
    total = 0
    for v in fwd.outvars[1:]:
        try:
            total += int(np.prod(v.aval.shape)) * v.aval.dtype.itemsize
        except (AttributeError, TypeError):
            pass
    return total


def test_training_activation_bytes_orders_and_ratio(monkeypatch):
    monkeypatch.setattr(jfusion, "_residual_bytes_of", _jax_residual_bytes)
    unfused = _bn_cnn()
    fused = jfusion.fuse(unfused)
    remat = jplan._with_remat(fused, {0: "nothing_saveable", 1: "nothing_saveable"})
    got = {}
    for name, jconf in (("unfused", unfused), ("fused", fused), ("remat", remat)):
        j = jfusion.training_activation_bytes(jconf, minibatch=16)
        p = pfusion.training_activation_bytes(_port_conf(jconf), minibatch=16)
        assert 0.5 <= p / j <= 2.0, (name, p, j)
        got[name] = (j, p)
    for side in (0, 1):
        assert got["fused"][side] < got["unfused"][side]
        assert got["remat"][side] < got["fused"][side]
    # the memory reports carry the port's measurement
    assert _port_conf(fused).memory_report(minibatch=16).training_activation_bytes == \
        got["fused"][1]


# ----------------------------------------------------------- the record's path
def _jax_tuned_net(jconf, jrec):
    return jauto.build_network(jconf, jrec).init()


def test_zips_and_shard_sets_carry_the_record_both_ways(tmp_path):
    jconf = _bn_cnn(blocks=1, n_out=4, side=SIDE)
    jrec = _record(jauto, jconf, tuned_signature=jauto.conf_signature(jfusion.fuse(jconf)),
                   fusion=True)
    jnet = _jax_tuned_net(jconf, jrec)
    path = str(tmp_path / "j.zip")
    jser.write_model(jnet, path)
    pnet = pser.restore(path, device="cpu")
    assert pnet._tuning_record.to_dict() == jrec.to_dict()
    pmodel, _ = pshd.restore_from_payloads(
        [jshd.shard_zip_bytes(jshd.shard_snapshot(jnet))], device="cpu")
    assert pmodel._tuning_record.to_dict() == jrec.to_dict()
    # and back: the port's zip, checkpoint and shard set into the JAX package
    prec = pauto.TuningRecord.from_dict(jrec.to_dict())
    pnet2 = pauto.build_network(_port_conf(jconf), prec, device="cpu").init()
    path2 = str(tmp_path / "p.zip")
    pser.write_model(pnet2, path2)
    assert jser.restore(path2)._tuning_record.to_dict() == jrec.to_dict()
    ck = pser.checkpoint_zip_bytes(pser.snapshot_training_state(pnet2))
    jback, meta = jser.restore_checkpoint(io.BytesIO(bytes(ck)))
    assert meta["has_tuning_record"] and jback._tuning_record.to_dict() == jrec.to_dict()
    jmodel, _ = jshd.restore_from_payloads([pshd.shard_zip_bytes(pshd.shard_snapshot(pnet2))])
    assert jmodel._tuning_record.to_dict() == jrec.to_dict()


def test_serving_refuses_a_stale_record_and_warms_a_matching_one():
    from deeplearning4j_tpu_torch import serving as pserving
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    pconf = _port_conf(_mlp())
    net = MultiLayerNetwork(pconf, device="cpu").init()
    stale = _record(pauto, _port_conf(_bn_cnn()))
    with pytest.raises(pauto.StaleTuningRecordError):
        ParallelInference(net, tuning=stale, device="cpu")
    srv = pserving.ModelServer()
    with pytest.raises(pauto.StaleTuningRecordError):
        srv.add_model("m", net, tuning=stale)
    good = _record(pauto, pconf, buckets=(4, 8))
    ep = srv.add_model("m", net, tuning=good)
    try:
        st = ep.pi.stats()
        assert st["tuning"] == {"applied": True, "buckets": [4, 8]}
        assert st["warmed_buckets"] == [4, 8] and ep.pi._tuning_example().shape == (1, 5)
        ep.pi.output(np.zeros((3, 5), np.float32))
        assert ep.pi.stats()["unwarmed_dispatches"] == 0
    finally:
        ep.pi.shutdown()
    # a record restored with the model rides along
    net._tuning_record = good
    pi = ParallelInference(net, inference_mode="sequential", device="cpu")
    try:
        assert pi.stats()["tuning"]["applied"] and pi.bucket_policy.bucket(3) == 4
    finally:
        pi.shutdown()


def test_fit_rebatches_to_the_record_as_the_jax_fit_does():
    jconf = _mlp()
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((4, 5)).astype(np.float32),
                np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 4)])
               for _ in range(5)]
    jrec = _record(jauto, jconf, batch_size=6)
    jnet = JaxNet(jconf).init()
    jnet._tuning_record = jrec
    pnet = MultiLayerNetwork(_port_conf(jconf), device="cpu")
    pnet.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                    state_from_jax(_host(jnet.state), device="cpu"))
    pnet._tuning_record = pauto.TuningRecord.from_dict(jrec.to_dict())
    sizes = []
    step = pnet._fit_batch
    pnet._fit_batch = lambda ds: sizes.append(ds.num_examples()) or step(ds)
    jnet.fit([JaxDataSet(x, y) for x, y in batches])
    pnet.fit([DataSet(x, y) for x, y in batches])
    assert sizes == [6, 6, 6, 2] and pnet.iteration == jnet.iteration == 4
    for p, j in zip(pnet.params, _host(jnet.params)):
        for k in j:
            np.testing.assert_allclose(p[k].numpy(), j[k], rtol=1e-5, atol=1e-6)


def test_tiny_autotune_on_lenet_returns_a_valid_record():
    pconf = pm.LeNet().conf()
    rec = pauto.autotune(pconf, batch_sizes=(8, 16), reps=1, top_k=2, device="cpu")
    pauto.verify_tuning(pconf, rec)
    assert rec.batch_size in (8, 16) and not rec.fusion and rec.candidates_searched == 2
    assert rec.buckets == (8,) if rec.batch_size == 8 else rec.buckets == (8, 16)
    assert rec.objective["step_seconds"] > 0 and rec.objective["flops"] > 0
    assert rec.baseline["bytes_accessed"] > 0 and rec.pallas_kernels is None
    assert [c["batch_size"] for c in pauto.autotune.last_search] in ([8, 16], [16, 8])
    assert all(c["step_seconds"] is not None for c in pauto.autotune.last_search)
    back = jauto.TuningRecord.from_json(rec.to_json())
    jauto.verify_tuning(jm.LeNet().conf(), back)
    assert json.loads(back.to_json()) == rec.to_dict()
    net = pauto.build_network(pconf, rec, device="cpu")
    assert net._tuning_record is rec and net.conf.to_json() == pconf.to_json()
