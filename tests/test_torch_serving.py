"""The PyTorch port's serving slice against the JAX package, on the CPU.

A narrow VGG-shaped network (16x16x3; conv blocks of 8 and 16 channels in
SAME and truncate modes, an asymmetric SAME pad at stride 2, SAME max
pooling; then Dense 33 -> Dense 24 -> Output 10) is built by the JAX
package, carried to the port through its JSON and ``params_from_jax``, and
run through both: fp32 output, calibration, int4 quantization and
``ParallelInference``. Inputs come from numpy with a fixed seed; the JAX
int4 layers run the Pallas kernel in interpret mode.

Tolerances: fp32 outputs and calibration ranges within 1e-5 relative — the
conv and matmul summation orders of torch and XLA differ on the CPU. The
int4 nets share the JAX calibration record, so their integer paths are
exact and the logits agree within 1e-6 relative (expected bitwise).
"""

import ast
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.vgg import VGG16 as JaxVGG16
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.perf import pallas as pk
from deeplearning4j_tpu.quant import calibrate as jax_calibrate
from deeplearning4j_tpu.quant import quantize as jax_quantize

from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.models import VGG16
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.perf.kernels import int4_dot
from deeplearning4j_tpu_torch.quant import CalibrationRecord, calibrate, quantize

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "deeplearning4j_tpu_torch")


def _jax_conf():
    return (JaxNNC.builder().seed(21).weight_init("relu").list()
            .layer(jconv.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                          convolution_mode="same", activation="relu"))
            .layer(jconv.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                          convolution_mode="same", activation="relu"))
            .layer(jconv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(jconv.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                          convolution_mode="truncate", activation="relu"))
            .layer(jconv.ConvolutionLayer(n_out=16, kernel_size=(3, 3), stride=(2, 2),
                                          convolution_mode="same", activation="relu"))
            .layer(jconv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                          convolution_mode="same"))
            .layer(jlayers.DenseLayer(n_out=33, activation="relu", dropout=0.5))
            .layer(jlayers.DenseLayer(n_out=24, activation="relu"))
            .layer(jlayers.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(16, 16, 3))
            .build())


def _host_params(net):
    return [{k: np.asarray(v) for k, v in p.items()} for p in net.params]


def _port_of(jax_net):
    net = MultiLayerNetwork(conf_from_jax_json(jax_net.conf.to_json()), device="cpu")
    net.params = params_from_jax(_host_params(jax_net), device="cpu")
    return net


@pytest.fixture(scope="module")
def nets():
    """JAX net, its port, calibration batches, and both int4 nets built from
    the JAX calibration record."""
    jnet = JaxMLN(_jax_conf()).init()
    pnet = _port_of(jnet)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((6, 16, 16, 3)).astype(np.float32)
               for _ in range(2)]
    jrec = jax_calibrate(jnet, batches)
    prec = CalibrationRecord.from_json(jrec.to_json())
    with pk.override(enabled=True):
        jq = jax_quantize(jnet, jrec, weight_bits=4)
    pq = quantize(pnet, prec, weight_bits=4)
    return {"jnet": jnet, "pnet": pnet, "batches": batches, "jrec": jrec,
            "jq": jq, "pq": pq}


@functools.lru_cache(maxsize=None)
def _jax_int4_fn(jq):
    return jax.jit(lambda p, s, x: jq._forward(p, s, x, False, None, None)[:2])


def _jax_int4(jq, x):
    """(pre-softmax logits, softmax) of the JAX int4 net, Pallas interpret."""
    with pk.override(enabled=True):
        acts, preout = _jax_int4_fn(jq)(jq.params, jq.state, jnp.asarray(x))
        return np.asarray(preout), np.asarray(acts[-1])


def test_conf_json_round_trips_both_ways(nets):
    s = nets["jnet"].conf.to_json()
    assert conf_from_jax_json(s).to_json() == s
    assert VGG16().conf().to_json() == JaxVGG16().conf().to_json()


def test_fp32_output_matches_jax(nets):
    x = np.random.default_rng(1).standard_normal((5, 16, 16, 3)).astype(np.float32)
    want = nets["jnet"].output(x)
    got = nets["pnet"].output(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    acts_j = nets["jnet"].feed_forward(x)
    acts_p = nets["pnet"].feed_forward(x)
    for a, b in zip(acts_p, acts_j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_calibration_matches_jax(nets):
    prec = calibrate(nets["pnet"], nets["batches"])
    jrec = nets["jrec"]
    assert prec.signature == jrec.signature
    assert prec.batches == jrec.batches == 2
    for key, want in jrec.ranges.items():
        got = prec.ranges[key]
        for field in ("min", "max", "amax", "scale"):
            assert got[field] == pytest.approx(want[field], rel=1e-5), (key, field)
        assert got["zero_point"] == 0


def test_percentile_calibration_matches_jax(nets):
    jrec = jax_calibrate(nets["jnet"], nets["batches"], observer="percentile",
                         percentile=99.0)
    prec = calibrate(nets["pnet"], nets["batches"], observer="percentile",
                     percentile=99.0)
    for key, want in jrec.ranges.items():
        assert prec.ranges[key]["amax"] == pytest.approx(want["amax"], rel=1e-5)


def test_int4_weights_bitwise_and_logits_match_jax(nets):
    jq, pq = nets["jq"], nets["pq"]
    assert [type(l).__name__ for l in pq.layers] == [type(l).__name__ for l in jq.layers]
    for jp, pp in zip(jq.params, pq.params):
        assert sorted(jp) == sorted(pp)
        for k in jp:
            assert np.array_equal(pp[k].numpy(), np.asarray(jp[k])), k
    x = np.random.default_rng(2).standard_normal((7, 16, 16, 3)).astype(np.float32)
    jlogits, jprob = _jax_int4(jq, x)
    acts = pq.feed_forward(x)
    plogits = pq.layers[-1].pre_output(pq.params[-1], acts[-2]).numpy()
    np.testing.assert_allclose(plogits, jlogits, rtol=1e-6, atol=0)
    np.testing.assert_allclose(acts[-1].numpy(), jprob, rtol=0, atol=1e-6)


def test_int4_dense_layers_go_through_the_kernel_wrapper(nets, monkeypatch):
    calls = []
    real = int4_dot.int4_matmul

    def spy(qq, packed, d):
        calls.append((tuple(qq.shape), d))
        return real(qq, packed, d)

    monkeypatch.setattr(int4_dot, "int4_matmul", spy)
    nets["pq"].output(nets["batches"][0][:3])
    assert calls == [((3, 64), 64), ((3, 33), 33), ((3, 24), 24)]


def test_parallel_inference_mixed_requests_match_jax(nets):
    pq = nets["pq"]
    rng = np.random.default_rng(3)
    reqs = [rng.standard_normal((r, 16, 16, 3)).astype(np.float32)
            for r in (1, 5, 2, 4, 3, 1, 5)]
    pi = ParallelInference(pq, batch_limit=3, device="cpu")
    try:
        obs = [pi.submit(x) for x in reqs]
        outs = [o.get(timeout=60) for o in obs]
        stats = pi.stats()
    finally:
        pi.shutdown()
    assert stats["requests_served"] == len(reqs)
    assert stats["batches_dispatched"] >= 3
    assert all(t % 8 == 0 for t in stats["bucket_dispatches"])
    jax_prob = _jax_int4(nets["jq"], np.concatenate(reqs))[1]
    ofs = 0
    for x, out in zip(reqs, outs):
        assert out.shape == (len(x), 10)
        np.testing.assert_array_equal(out, pq.output(x).numpy())
        np.testing.assert_allclose(out, jax_prob[ofs:ofs + len(x)], rtol=0, atol=1e-6)
        ofs += len(x)
    np.testing.assert_array_equal(
        ParallelInference(pq, device="cpu").output(reqs[1]), outs[1])


@pytest.mark.parametrize("pooling", ["max", "avg", "pnorm"])
def test_pooling_modes_match_jax(pooling):
    conf = (JaxNNC.builder().seed(8).list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                          convolution_mode="same", activation="tanh"))
            .layer(jconv.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          convolution_mode="same", pooling_type=pooling))
            .layer(jconv.SubsamplingLayer(kernel_size=(2, 2), stride=(1, 1),
                                          padding=(1, 1), pooling_type=pooling))
            .layer(jlayers.OutputLayer(n_out=3, activation="identity", loss="mse"))
            .set_input_type(JaxInputType.convolutional(7, 7, 2))
            .build())
    jnet = JaxMLN(conf).init()
    x = np.random.default_rng(4).standard_normal((3, 7, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(_port_of(jnet).output(x).numpy(), jnet.output(x),
                               rtol=1e-5, atol=1e-6)


def test_jax_quantized_conv1d_net_runs_in_the_port():
    """A quantized conf written by the JAX package (int4 Conv1D layers, and a
    dense layer on 3-D activations, which the port reshapes to 2-D for the
    int4 kernel) is read, loaded and run by the port."""
    conf = (JaxNNC.builder().seed(5).weight_init("relu").list()
            .layer(jconv.Convolution1DLayer(n_out=6, kernel_size=3,
                                            convolution_mode="same", activation="relu"))
            .layer(jconv.Convolution1DLayer(n_out=5, kernel_size=2, stride=2,
                                            activation="relu"))
            .layer(jlayers.DenseLayer(n_out=7, activation="relu"))
            .layer(jlayers.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(5, 12))
            .build())
    jnet = JaxMLN(conf).init()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 12, 5)).astype(np.float32)
    jq = jax_quantize(jnet, jax_calibrate(jnet, [x]), weight_bits=4)
    pq = _port_of(jq)
    assert [type(l).__name__ for l in pq.layers] == [
        "QuantizedConvolution1DLayer", "QuantizedConvolution1DLayer",
        "QuantizedDenseLayer", "QuantizedOutputLayer"]
    np.testing.assert_allclose(pq.output(x).numpy(), jq.output(x), rtol=1e-6, atol=1e-7)


def test_port_vgg16_initializes_and_serves_on_cpu():
    net = VGG16(num_classes=10, input_shape=(32, 32, 3)).init(device="cpu")
    assert tuple(net.params[18]["W"].shape) == (512, 4096)   # (h, w, c)-flat fc1
    std = float(net.params[0]["W"].std())
    assert 0.5 * np.sqrt(2 / 27) < std < 1.5 * np.sqrt(2 / 27)  # He init, fan-in 27
    out = net.output(np.zeros((2, 32, 32, 3), np.float32))
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)


def test_no_card_and_no_device_raises(nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(nets["pnet"].conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelInference(nets["pq"])
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ParallelInference(nets["pq"], device="meta")


def test_port_imports_nothing_of_jax():
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['deeplearning4j_tpu'] = None\n"
        "import deeplearning4j_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    # lazy imports inside functions too: no import statement names them
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO_ROOT, "chip_smoke.py")]
    rel = {os.path.relpath(f, PORT).replace(os.sep, "/") for f in files}
    for module in ("retrieval/index.py", "retrieval/pq.py", "retrieval/build.py",
                   "retrieval/gates.py", "retrieval/service.py",
                   "clustering/kmeans.py", "serving/breaker.py",
                   "perf/kernels/adc.py", "perf/kernels/scatter_add.py",
                   "nlp/__init__.py", "nlp/kernels.py", "nlp/sequencevectors.py",
                   "nlp/word2vec.py", "nlp/paragraphvectors.py", "nlp/glove.py",
                   "nlp/serializer.py", "nlp/vocab.py", "nlp/tokenization.py",
                   "nlp/sentenceiterator.py", "interop.py", "utils/http.py",
                   "serving/wire.py", "serving/decode.py", "serving/server.py",
                   "serving/__init__.py", "serving/__main__.py",
                   "parallel/inference.py", "checkpoint/manager.py"):
        assert module in rel, module
    for path in files:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "deeplearning4j_tpu"), (path, name)
