"""The port's HTTP serving tier against the JAX package's, on the CPU.

The same request bodies go to both packages' ``ModelServer``, each running
in-process on a free loopback port around a gated net (the model wrapper of
``tests/test_serving.py``, whose dispatches can be held or told to fail)
and a brute-force index the JAX package built and the port loaded from its
``.npz``. Every route and the whole status-code and ``reason`` taxonomy
must agree: 200, 400 bad_request, 404 unknown_model / unknown_index /
not_found, 413 body_too_large, 429 shed with Retry-After, 500
dispatch_failed, 503 breaker_open / draining, 504 deadline_expired, and
``/readyz`` 503 before warm-up. The wire format, ``parse_content_length``
and the command-line server (``python -m deeplearning4j_tpu_torch.serving``)
are checked too.

Tolerances: predict outputs within 1e-6 absolute of the JAX server's (the
same weights; torch and XLA sum the matmuls in another order); query ids
equal and distances within rtol 1e-5, as in tests/test_torch_retrieval.py.
Wire frames are bitwise.
"""

import base64
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import retrieval as jr
from deeplearning4j_tpu import serving as jserving
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.serving import wire as jwire
from deeplearning4j_tpu.utils.http import parse_content_length as jax_parse_cl

from deeplearning4j_tpu_torch import serving as pserving
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.retrieval import load_index
from deeplearning4j_tpu_torch.serving import wire as pwire
from deeplearning4j_tpu_torch.utils.http import parse_content_length

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ATOL = 1e-6


def _jax_net(seed=42, n_in=4, n_out=3):
    conf = (JaxNNC.builder().seed(seed).weight_init("xavier").list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=n_out, loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(n_in)).build())
    return JaxMLN(conf).init()


def _port_of(jnet):
    net = MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    net.params = params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                  for p in jnet.params], device="cpu")
    return net


class GatedNet:
    """Delegating model wrapper whose forward can be HELD at a gate or
    scripted to fail (tests/test_serving.py's lever), for either package."""

    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.fail_next = 0
        self.dispatches = 0
        self._lock = threading.Lock()

    @property
    def params(self):
        return self._inner.params

    @params.setter
    def params(self, v):
        self._inner.params = v

    @property
    def state(self):
        return self._inner.state

    @state.setter
    def state(self, v):
        self._inner.state = v

    def init(self):
        self._inner.init()
        return self

    def output(self, arr):
        self.entered.set()
        assert self.gate.wait(30), "test gate leaked shut"
        with self._lock:
            self.dispatches += 1
            if self.fail_next > 0:
                self.fail_next -= 1
                raise RuntimeError("scripted model fault")
        return self._inner.output(arr)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)


def _call(base, method, path, body=None, headers=None, timeout=30):
    """(status, parsed JSON or raw text, headers) of one request."""
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, code, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, code, hdrs = e.read(), e.code, dict(e.headers)
    try:
        return code, json.loads(raw), hdrs
    except ValueError:
        return code, raw.decode(), hdrs


def _no_length_post(srv, path):
    """A POST without a Content-Length header."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    try:
        conn.putrequest("POST", path)
        conn.endheaders()
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _b64(arr, **extra):
    a = np.ascontiguousarray(arr)
    return {"x_b64": base64.b64encode(a.astype(a.dtype.newbyteorder("<")).tobytes()
                                      ).decode(), "dtype": str(a.dtype),
            "shape": list(a.shape), **extra}


def _wait(pred, what, timeout=10.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _scenario(pkg, net, index, x, q):
    """Drive one server through every route and the whole taxonomy; returns
    ([(label, status, reason)], {label: payload}) for the comparison."""
    # deadlines long enough for a loaded machine; the 504 case sets its own
    srv = pkg.ModelServer(max_body_bytes=4096, default_deadline_ms=30_000)
    gated = GatedNet(net)
    ep = srv.add_model("m", gated, warmup_example=np.zeros((1, 4), np.float32),
                       queue_depth=2, batch_limit=1, default_deadline_ms=30_000,
                       breaker=pkg.CircuitBreaker(failure_threshold=2, cooldown_s=600))
    srv.add_index("ix", index, k_max=16, warmup_queries=8, batch_limit=2)
    srv.start(warmup=False)
    rows, payloads = [], {}

    def rec(label, res):
        code, body, hdrs = res if len(res) == 3 else (*res, {})
        reason = body.get("reason") if isinstance(body, dict) else None
        rows.append((label, code, reason, "Retry-After" in hdrs))
        payloads[label] = body
        return code, body

    base = srv.address
    pred = "/v1/models/m:predict"
    try:
        rec("readyz_cold", _call(base, "GET", "/readyz"))
        srv.warmup()
        rec("readyz_warm", _call(base, "GET", "/readyz"))
        for path in ("/healthz", "/v1/models", "/v1/models/m", "/v1/models/zz",
                     "/v1/indexes", "/v1/indexes/ix", "/v1/indexes/zz", "/nope"):
            rec("GET " + path, _call(base, "GET", path))
        rec("json", _call(base, "POST", pred, {"inputs": x.tolist()}))
        rec("b64_f32", _call(base, "POST", pred, _b64(x)))
        rec("b64_f64", _call(base, "POST", pred, _b64(x.astype(np.float64))))
        rec("b64_i8_unquantized", _call(base, "POST", pred, _b64(x.astype(np.int8))))
        rec("b64_bad_dtype", _call(base, "POST", pred, _b64(x.astype(np.int16))))
        rec("b64_short", _call(base, "POST", pred,
                               dict(_b64(x), shape=[4, 4])))
        rec("not_json", _call(base, "POST", pred, b"this is not json"))
        rec("not_object", _call(base, "POST", pred, [1, 2]))
        rec("no_tensor", _call(base, "POST", pred, {}))
        rec("no_batch_axis", _call(base, "POST", pred, {"inputs": [0.0] * 4}))
        rec("wrong_features", _call(base, "POST", pred, {"inputs": np.zeros((2, 7)).tolist()}))
        rec("unknown_model", _call(base, "POST", "/v1/models/zz:predict", {"inputs": x.tolist()}))
        rec("unknown_route", _call(base, "POST", "/v1/nope", {}))
        rec("oversized", _call(base, "POST", pred, b"{" + b" " * 5000 + b"}"))
        rec("no_length", _no_length_post(srv, pred))
        qpath = "/v1/indexes/ix:query"
        rec("query_json", _call(base, "POST", qpath, {"queries": q.tolist(), "k": 5}))
        rec("query_b64", _call(base, "POST", qpath, _b64(q, k=5, b64=True)))
        rec("query_i8_noscale", _call(base, "POST", qpath, _b64(q.astype(np.int8), k=3)))
        rec("query_i8_scale", _call(base, "POST", qpath,
                                    _b64(np.round(q * 10).astype(np.int8), k=3, scale=0.1)))
        rec("query_k0", _call(base, "POST", qpath, {"queries": q.tolist(), "k": 0}))
        rec("query_k_big", _call(base, "POST", qpath, {"queries": q.tolist(), "k": 17}))
        rec("query_dim", _call(base, "POST", qpath, {"queries": [[0.0] * 3]}))
        rec("query_rows", _call(base, "POST", qpath,
                                {"queries": np.zeros((9, q.shape[1])).tolist()}))
        rec("query_unknown", _call(base, "POST", "/v1/indexes/zz:query", {"queries": q.tolist()}))
        rec("generate_unknown", _call(base, "POST", "/v1/models/m:generate", {"prompt_ids": [1]}))

        # 429: one dispatch held at the gate, the bounded queue (2) full
        gated.gate.clear()
        gated.entered.clear()
        held = []

        def bg(body):
            t = threading.Thread(target=lambda: held.append(_call(base, "POST", pred, body)))
            t.start()
            return t

        threads = [bg({"inputs": x[:1].tolist()})]
        _wait(gated.entered.is_set, "the held dispatch")
        threads += [bg({"inputs": x[:1].tolist()}) for _ in range(2)]
        _wait(lambda: ep.pi.stats()["queue"]["size"] == 2, "a full queue")
        rec("shed", _call(base, "POST", pred, {"inputs": x[:1].tolist()}))
        gated.gate.set()
        for t in threads:
            t.join(30)
        rows.append(("held_then_served", sorted(r[0] for r in held), None, False))

        # 504: a request whose deadline passes while the worker is held
        gated.gate.clear()
        gated.entered.clear()
        held = []
        threads = [bg({"inputs": x[:1].tolist()})]
        _wait(gated.entered.is_set, "the held dispatch")
        threads.append(bg({"inputs": x[:1].tolist(), "deadline_ms": 50}))
        _wait(lambda: ep.pi.stats()["queue"]["size"] == 1, "the queued request")
        time.sleep(0.1)
        gated.gate.set()
        for t in threads:
            t.join(30)
        rows.append(("deadline", sorted((r[0], r[1].get("reason")) for r in held),
                     None, False))

        # 503 while draining: predict, query and readiness
        assert srv.drain(timeout_s=5)
        rec("drain_predict", _call(base, "POST", pred, {"inputs": x.tolist()}))
        rec("drain_query", _call(base, "POST", qpath, {"queries": q.tolist()}))
        rec("drain_readyz", _call(base, "GET", "/readyz"))
        srv.undrain()

        # 500 twice, then the breaker opens: 503 breaker_open
        gated.fail_next = 2
        rec("fault_1", _call(base, "POST", pred, {"inputs": x.tolist()}))
        rec("fault_2", _call(base, "POST", pred, {"inputs": x.tolist()}))
        rec("breaker", _call(base, "POST", pred, {"inputs": x.tolist()}))

        code, text, _ = _call(base, "GET", "/metrics")
        rows.append(("metrics", code, None, False))
        payloads["metrics"] = text
    finally:
        srv.stop(drain=False)
    return rows, payloads


EXPECTED = {
    "readyz_cold": (503, None), "readyz_warm": (200, None),
    "GET /v1/models/zz": (404, "unknown_model"), "GET /v1/indexes/zz": (404, "unknown_index"),
    "GET /nope": (404, "not_found"), "json": (200, None), "b64_f32": (200, None),
    "b64_f64": (200, None), "b64_i8_unquantized": (400, "bad_request"),
    "b64_bad_dtype": (400, "bad_request"), "b64_short": (400, "bad_request"),
    "not_json": (400, "bad_request"), "not_object": (400, "bad_request"),
    "no_tensor": (400, "bad_request"), "no_batch_axis": (400, "bad_request"),
    "wrong_features": (400, "bad_request"), "unknown_model": (404, "unknown_model"),
    "unknown_route": (404, "not_found"), "oversized": (413, "body_too_large"),
    "no_length": (400, "bad_request"), "query_json": (200, None), "query_b64": (200, None),
    "query_i8_noscale": (400, "bad_request"), "query_i8_scale": (200, None),
    "query_k0": (400, "bad_request"), "query_k_big": (400, "bad_request"),
    "query_dim": (400, "bad_request"), "query_rows": (400, "bad_request"),
    "query_unknown": (404, "unknown_index"), "generate_unknown": (404, "unknown_model"),
    "shed": (429, "shed"), "drain_predict": (503, "draining"),
    "drain_query": (503, "draining"), "drain_readyz": (503, None),
    "fault_1": (500, "dispatch_failed"), "fault_2": (500, "dispatch_failed"),
    "breaker": (503, "breaker_open"), "metrics": (200, None),
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jnet = _jax_net()
    pnet = _port_of(jnet)
    rng = np.random.default_rng(0)
    V = rng.standard_normal((300, 8)).astype(np.float32)
    jix = jr.BruteForceIndex(V)
    pix = load_index(jix.save(str(tmp_path_factory.mktemp("ix") / "b.npz")), device="cpu")
    x = rng.random((3, 4)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    return (_scenario(jserving, jnet, jix, x, q), _scenario(pserving, pnet, pix, x, q))


def test_same_status_codes_and_reasons_on_every_route(both):
    (jrows, _), (prows, _) = both
    assert prows == jrows
    got = {label: (code, reason) for label, code, reason, _ in prows}
    for label, want in EXPECTED.items():
        assert got[label] == want, label
    retry = {label for label, _, _, has in prows if has}
    assert {"shed", "drain_predict", "drain_query", "breaker"} <= retry
    assert got["held_then_served"][0] == [200, 200, 200]
    assert got["deadline"][0] == [(200, None), (504, "deadline_expired")]


def test_same_answers_and_metrics(both):
    (_, jp), (_, pp) = both
    for label in ("json", "b64_f32", "b64_f64"):
        np.testing.assert_allclose(np.asarray(pp[label]["outputs"]),
                                   np.asarray(jp[label]["outputs"]), rtol=0, atol=OUT_ATOL)
    for label in ("query_json", "query_i8_scale"):
        assert pp[label]["indices"] == jp[label]["indices"]
        np.testing.assert_allclose(pp[label]["distances"], jp[label]["distances"], rtol=1e-5)
    for key in ("indices_b64", "shape"):
        assert pp["query_b64"][key] == jp["query_b64"][key]
    for label in ("b64_i8_unquantized", "b64_bad_dtype", "b64_short", "no_tensor",
                  "query_i8_noscale", "query_k_big", "query_rows"):
        assert pp[label]["error"] == jp[label]["error"], label
    for name in ("serving_http_requests", "serving_requests_shed", "serving_requests_expired",
                 "serving_breaker_rejected", "serving_drain_rejected",
                 "serving_request_errors", "serving_retrieval_requests", "serving_request_ms",
                 "serving_inflight_requests", "serving_queue_depth",
                 "serving_batch_occupancy", "retrieval_queries", "retrieval_query_ms",
                 "retrieval_batch_occupancy", "retrieval_index_bytes"):
        assert name in pp["metrics"] and name in jp["metrics"], name
    assert pp["GET /v1/models/m"]["hot_swap"]["enabled"] is False
    assert set(pp["GET /v1/models"]["models"]["m"]) == set(jp["GET /v1/models"]["models"]["m"])


WIRE_ARRAYS = [np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5,
               np.linspace(-2, 2, 6).reshape(2, 3),
               np.array([[-128, -1, 0, 1, 127]], np.int8),
               np.arange(6, dtype=np.int32).reshape(3, 2) - 3,
               np.array([[1.5, -0.0, np.inf]], np.float32)]


@pytest.mark.parametrize("i", range(len(WIRE_ARRAYS)))
def test_wire_frames_bitwise_both_ways(i):
    a = WIRE_ARRAYS[i]
    for field in ("x_b64", "indices_b64"):
        assert pwire.encode_array(a, field) == jwire.encode_array(a, field)
    body = pwire.encode_array(a)
    if a.dtype.name in pwire.WIRE_DTYPES:
        kw = {"int8_scale": 0.25} if a.dtype == np.int8 else {}
        p, j = pwire.decode_array(body, **kw), jwire.decode_array(body, **kw)
        assert p.dtype == j.dtype == np.float32 and p.tobytes() == j.tobytes()
        assert body["x_b64"] == jwire.encode_array(a)["x_b64"]
    else:
        for mod in (pwire, jwire):
            with pytest.raises(ValueError, match="unsupported wire dtype"):
                mod.decode_array(body)


@pytest.mark.parametrize("body", [
    {"x_b64": "AAAA", "dtype": "float32", "shape": [2]},
    {"x_b64": "AAAAAA==", "dtype": "float32", "shape": []},
    {"x_b64": "AAAAAA==", "dtype": "float32", "shape": [0]},
    {"x_b64": "AQI=", "dtype": "int8", "shape": [2]},
    {"x_b64": "AQI=", "dtype": "int8", "shape": [2], "scale": 0.5},
    {"x_b64": "not base64!", "dtype": "float32", "shape": [1]},
])
def test_wire_decode_refusals_and_scales_match(body):
    def run(mod, **kw):
        try:
            return ("ok", mod.decode_array(body, **kw).tobytes())
        except (ValueError, TypeError) as e:
            return ("error", str(e))

    for kw in ({}, {"allow_explicit_scale": False}, {"int8_scale": 2.0}):
        assert run(pwire, **kw) == run(jwire, **kw)


@pytest.mark.parametrize("headers", [
    {}, {"Content-Length": ""}, {"Content-Length": "abc"}, {"Content-Length": "-1"},
    {"Content-Length": "0"}, {"Content-Length": "100"}, {"Content-Length": "101"},
    {"Content-Length": " 42 "}, {"Content-Length": "1e3"},
])
def test_parse_content_length_table(headers):
    assert parse_content_length(headers, 100) == jax_parse_cl(headers, 100)


def test_quantized_endpoint_takes_int8_on_its_grid():
    """add_model(quantize=) serves the lowering, publishes its input scale
    and decodes int8 payloads on it, like the JAX server."""
    from deeplearning4j_tpu.quant import calibrate as jcalibrate
    from deeplearning4j_tpu_torch.quant import CalibrationRecord

    jnet = _jax_net(seed=3)
    rng = np.random.default_rng(5)
    calib = [rng.random((8, 4)).astype(np.float32) for _ in range(2)]
    jrec = jcalibrate(jnet, calib)
    prec = CalibrationRecord.from_json(jrec.to_json())
    x = rng.random((2, 4)).astype(np.float32)
    outs = {}
    for name, pkg, net, rec in (("jax", jserving, jnet, jrec),
                                ("port", pserving, _port_of(jnet), prec)):
        srv = pkg.ModelServer(default_deadline_ms=60_000)  # the JAX side compiles first
        ep = srv.add_model("q", net, quantize=rec)
        srv.start(warmup=False)
        try:
            scale = ep.input_scale
            xq = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
            code, body, _ = _call(srv.address, "POST", "/v1/models/q:predict", _b64(xq))
            assert code == 200
            assert ep.stats()["quantized"] is True
            outs[name] = (scale, np.asarray(body["outputs"]))
        finally:
            srv.stop(drain=False)
    assert outs["port"][0] == outs["jax"][0]
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], rtol=0, atol=OUT_ATOL)


def test_refusals_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="A7"):
        pserving.ModelServer(compile_cache_dir="/nonexistent")
    srv = pserving.ModelServer()
    # tuning records are ported (perf/autotune.py): a stale one is refused by name
    from deeplearning4j_tpu_torch.perf.autotune import StaleTuningRecordError, TuningRecord
    stale = TuningRecord(model_type="MultiLayerConfiguration", dtype="float32",
                         signature=(("layer0", "DenseLayer", 3),),
                         tuned_signature=(("layer0", "DenseLayer", 3),), batch_size=8,
                         fusion=False, donate=True, remat={}, buckets=(8,), objective={},
                         baseline={}, candidates_searched=1)
    with pytest.raises(StaleTuningRecordError):
        srv.add_model("t", _port_of(_jax_net()), tuning=stale)
    # meshes are ported (parallel/mesh.py); one of several ranks is refused
    # by design, each rank serving on its own device
    import torch
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh, MultiRankMeshError
    with pytest.raises(MultiRankMeshError, match="C2"):
        ParallelInference(_port_of(_jax_net()), device="cpu",
                          mesh=Mesh(np.arange(2).reshape(2, 1), torch.device("cpu")))


def test_command_line_server_serves_and_drains(tmp_path):
    """``python -m deeplearning4j_tpu_torch.serving --model name=dir``
    restores the checkpoint, answers /readyz and predict, and drains and
    stops on SIGTERM."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager

    net = _port_of(_jax_net(seed=9))
    cm = CheckpointManager(str(tmp_path / "iris"), device="cpu", async_write=False)
    cm.save(net)
    cm.close()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.serving",
         "--model", f"iris={tmp_path / 'iris'}", "--port", "0", "--device", "cpu",
         "--deadline-ms", "60000"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, f"server exited: {proc.stderr.read()}"
            lines.append(line)
            if line.startswith("serving "):
                break
        base = line.split(" on ")[1].split(" ")[0]
        assert "serving checkpoint step 0" in lines[0]
        code, body, _ = _call(base, "GET", "/readyz")
        assert code == 200 and body == {"ready": True}
        x = np.random.default_rng(1).random((2, 4)).astype(np.float32)
        code, body, _ = _call(base, "POST", "/v1/models/iris:predict", {"inputs": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["outputs"]), net.output(x).numpy(),
                                   rtol=0, atol=OUT_ATOL)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0 and "drained and stopped." in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    from deeplearning4j_tpu_torch.serving.__main__ import build_parser, main
    args = build_parser().parse_args(["--model", "a=/x", "--model", "b=/y=z",
                                      "--weight-bits", "4"])
    assert args.model == [("a", "/x"), ("b", "/y=z")] and args.weight_bits == 4
    for bad in (["--model", "bad"], ["--model", "=dir"], ["--model", "name="]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)
    assert main([]) == 2
