"""The port's quantization accuracy gate on the CPU against the JAX
package's: ``accuracy_delta`` over the same float network and the same
int8 / int4 lowering of it (the JAX package's calibration record, its
Pallas int4 kernel in interpret mode) gives the JAX report: example
counts, top-1 accuracies and agreement exact, mean losses within rtol 1e-5
(the quantized logits agree to float32 rounding). ``assert_accuracy_within``
raises the JAX package's message for the same report, and the port's
registry carries ``quant_accuracy_delta``.

Inputs come from numpy with fixed seeds.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.conf.network import Builder as JBuilder
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.perf import pallas as pk
from deeplearning4j_tpu.quant import calibrate as jcalibrate
from deeplearning4j_tpu.quant import gates as jgates
from deeplearning4j_tpu.quant import quantize as jquantize

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.quant import CalibrationRecord, quantize
from deeplearning4j_tpu_torch.quant import gates as pgates


@pytest.fixture(scope="module")
def nets():
    jconf = (JBuilder().seed(31).weight_init("relu").list()
             .layer(JDense(n_out=32, activation="relu"))
             .layer(JDense(n_out=16, activation="relu"))
             .layer(JOutput(n_out=5, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.feed_forward(20)).build())
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    pnet.set_params(params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                     for p in jnet.params], device="cpu"))
    rng = np.random.default_rng(5)
    teacher = rng.standard_normal((20, 5)).astype(np.float32)
    batches = []
    for _ in range(4):
        x = rng.standard_normal((16, 20)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[(x @ teacher).argmax(-1)]
        batches.append((x, y))
    jrec = jcalibrate(jnet, [x for x, _ in batches[:2]])
    prec = CalibrationRecord.from_json(jrec.to_json())
    out = {"jnet": jnet, "pnet": pnet, "batches": batches}
    for bits in (8, 4):
        with pk.override(enabled=True):
            out[f"j{bits}"] = jquantize(jnet, jrec, weight_bits=bits)
        out[f"p{bits}"] = quantize(pnet, prec, weight_bits=bits)
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("top_n", [1, 2])
def test_accuracy_delta_report_matches_jax(nets, bits, top_n):
    b = nets["batches"]
    with pk.override(enabled=True):
        want = jgates.accuracy_delta(nets["jnet"], nets[f"j{bits}"],
                                     [JDataSet(x, y) for x, y in b], top_n=top_n)
    got = pgates.accuracy_delta(nets["pnet"], nets[f"p{bits}"],
                                [DataSet(x, y) for x, y in b], top_n=top_n)
    assert sorted(got) == sorted(want)
    for k in ("examples", "fp32_top1", "quant_top1", "top1_delta", "top1_agreement"):
        assert got[k] == want[k], k
    for k in ("fp32_loss", "quant_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["examples"] == 64
    reg = get_registry().metric("quant_accuracy_delta")
    assert reg is not None and reg.value == got["top1_delta"]


def test_accuracy_delta_with_a_labels_mask_and_tuples(nets):
    x, y = nets["batches"][0]
    m = (np.arange(16) % 3 != 0).astype(np.float32)
    with pk.override(enabled=True):
        want = jgates.accuracy_delta(nets["jnet"], nets["j4"], [JDataSet(x, y, labels_mask=m),
                                                               (x, y)])
    got = pgates.accuracy_delta(nets["pnet"], nets["p4"], [DataSet(x, y, labels_mask=m),
                                                           (x, y)])
    assert got["examples"] == want["examples"] == int(m.sum()) + 16
    assert got["top1_agreement"] == want["top1_agreement"]


@pytest.mark.parametrize("case", ["top1", "loss", "agreement", "pass"])
def test_assert_accuracy_within_raises_the_jax_message(case):
    report = {"examples": 10, "fp32_top1": 0.9, "quant_top1": 0.8, "top1_delta": 0.1,
              "top1_agreement": 0.7, "fp32_loss": 1.0, "quant_loss": 1.5,
              "loss_delta_rel": 0.5}
    kw = {"top1": dict(loss_budget=1.0), "loss": dict(top1_budget=1.0),
          "agreement": dict(top1_budget=1.0, loss_budget=1.0, agreement_floor=0.8),
          "pass": dict(top1_budget=1.0, loss_budget=1.0, agreement_floor=0.5)}[case]
    if case == "pass":
        assert pgates.assert_accuracy_within(report, **kw) is report
        return
    with pytest.raises(AssertionError) as want:
        jgates.assert_accuracy_within(report, **kw)
    with pytest.raises(AssertionError) as got:
        pgates.assert_accuracy_within(report, **kw)
    assert str(got.value) == str(want.value)


def test_empty_stream_raises(nets):
    with pytest.raises(ValueError, match="empty"):
        pgates.accuracy_delta(nets["pnet"], nets["p8"], [])
