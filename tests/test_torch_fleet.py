"""The port's serving fleet (``deeplearning4j_tpu_torch/fleet``) against the
JAX package's, on the CPU.

The contracts of ``tests/test_zz_serving_fleet.py``, over the port's own
modules: the lease board's prefix and payload protocol, membership through
a cold / warm / draining / expired / withdrawn lease, the router's placement
by model and by index and its relayed taxonomy, never routing to a cold
replica, retry of a transient failure against a different replica and no
retry of a non-idempotent POST after the send, ``parse_prometheus`` and
``histogram_quantile`` (equal to the JAX package's on the same text), the
autoscaler's decisions and cooldowns, placement-safe scale-down victims,
``restore_and_serve`` from a checkpoint with its named refusals, and the
CLI's parser, which accepts what ``tools/fleet.py``'s does.

Across the packages: the port's ``FleetRouter`` fronts one JAX and one
port ``ModelServer`` serving the same weights, each announced by its own
package's ``ServingReplica`` into one lease directory. The weights and
inputs are small integers, so both packages' products are exact and every
answer body through the router is byte for byte the direct answer of
either server.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.checkpoint.storage import ObjectStoreBackend
from deeplearning4j_tpu_torch.fleet import (Autoscaler, AutoscalerPolicy, FleetRouter,
                                            FleetView, ReplicaAnnouncer, ServingReplica,
                                            histogram_quantile, parse_prometheus,
                                            restore_and_serve)
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Sgd
from deeplearning4j_tpu_torch.parallel.leases import LeaseBoard
from deeplearning4j_tpu_torch.serving import ModelServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(seed=42, n_hidden=8):
    return (NeuralNetConfiguration.builder()
            .seed(seed).updater(Sgd(learning_rate=0.05))
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=n_hidden, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())


def _net(seed=42):
    return MultiLayerNetwork(_conf(seed), device="cpu").init()


def _post_raw(base, path, obj, timeout=30):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(base, path, obj, timeout=30):
    code, body = _post_raw(base, path, obj, timeout)
    return code, json.loads(body)


def _predict(base, model, inputs, timeout=30):
    return _post(base, f"/v1/models/{model}:predict",
                 {"inputs": np.asarray(inputs).tolist()}, timeout=timeout)


def _get(base, path, timeout=10):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------- lease board factoring
def test_lease_board_prefix_and_payload_protocol():
    store = ObjectStoreBackend()
    calls = {"n": 0}

    def sampler():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("stats hook died")
        return {"load": {"inflight": calls["n"]}}

    rb = LeaseBoard(store, "r0", ttl_s=5.0, prefix="replica-", payload_fn=sampler)
    rb.set_payload(address="http://127.0.0.1:1", models=["m"])
    rb.write()
    tb = LeaseBoard(store, "w0", ttl_s=5.0)  # elastic trainer, "lease-"
    tb.write()
    assert set(rb.read_all()) == {"r0"}
    assert set(tb.read_all()) == {"w0"}
    rec = rb.read_all()["r0"]
    assert rec["address"] == "http://127.0.0.1:1" and rec["models"] == ["m"]
    assert rec["load"] == {"inflight": 1}
    assert rec["incarnation"] and rec["seq"] == 1
    rb.write()  # the sampler raises this time: the write still lands
    assert rb.payload_errors == 1 and rb.read_all()["r0"]["seq"] == 2
    rb.write()
    assert rb.read_all()["r0"]["load"] == {"inflight": 3}
    from deeplearning4j_tpu_torch.parallel.elastic import LeaseBoard as Elastic
    assert Elastic is LeaseBoard


def test_replica_membership_lifecycle():
    store = ObjectStoreBackend()
    t = {"now": 1000.0}
    ann = ReplicaAnnouncer(store, "rep0", address="http://127.0.0.1:1234",
                           models=["iris"], indexes=["docs"], ttl_s=5.0,
                           heartbeat_s=999.0, clock=lambda: t["now"])
    ann.announce()
    view = FleetView(store, ttl_s=5.0, clock=lambda: t["now"])
    r = view.replicas()["rep0"]
    assert not r.ready and not r.warmed
    assert r.hosts_model("iris") and r.hosts_index("docs")
    assert r.host_port == ("127.0.0.1", 1234)
    assert view.for_model("iris") == []
    assert [x.replica_id for x in view.for_model("iris", ready_only=False)] == ["rep0"]
    ann.set_warmed(True)
    assert view.for_model("iris")[0].ready
    assert view.for_index("docs")[0].replica_id == "rep0"
    snap = view.snapshot()
    json.dumps(snap)
    assert snap["ready"] == ["rep0"]
    ann.set_draining(True)
    assert view.replicas() and view.ready() == {}
    ann.set_draining(False)
    assert view.ready()
    t["now"] += 5.1  # the observer's clock passes the TTL: silent death
    assert view.replicas() == {}
    ann.set_warmed(True)  # a fresh heartbeat write revives it
    assert view.ready()
    ann.withdraw()
    assert view.replicas() == {}


# ----------------------------------------------------- routing and placement
def test_router_placement_models_and_indexes():
    from deeplearning4j_tpu_torch.retrieval import BruteForceIndex
    store = ObjectStoreBackend()
    rng = np.random.default_rng(0)
    V = rng.standard_normal((32, 8)).astype(np.float32)
    srv_a = ModelServer()
    srv_a.add_model("small", _net(0), warmup_example=np.zeros((1, 4), np.float32))
    srv_b = ModelServer()
    srv_b.add_model("big", _net(1), warmup_example=np.zeros((1, 4), np.float32))
    srv_b.add_index("vecs", BruteForceIndex(V, device="cpu"), k_default=3,
                    warmup_queries=8)
    rep_a = ServingReplica(srv_a, store, "repA", heartbeat_s=0.5).start()
    rep_b = ServingReplica(srv_b, store, "repB", heartbeat_s=0.5).start()
    router = None
    try:
        assert rep_a.wait_ready(120) and rep_b.wait_ready(120)
        router = FleetRouter(FleetView(store), refresh_s=0.1, seed=0).start()
        base = router.address
        code, body = _get(base, "/v1/models")
        assert code == 200 and body["models"] == ["big", "small"]
        assert body["placement"] == {"small": ["repA"], "big": ["repB"]}
        code, body = _get(base, "/v1/indexes")
        assert body["placement"] == {"vecs": ["repB"]}
        x = rng.random((3, 4)).astype(np.float32)
        code, out = _predict(base, "small", x)
        assert code == 200 and np.asarray(out["outputs"]).shape == (3, 3)
        code, out = _predict(base, "big", x)
        assert code == 200 and out["model"] == "big"
        code, out = _post(base, "/v1/indexes/vecs:query", {"queries": V[:2].tolist(), "k": 3})
        assert code == 200 and np.asarray(out["indices"]).shape == (2, 3)
        assert out["indices"][0][0] == 0 and out["indices"][1][0] == 1
        code, err = _predict(base, "small", np.zeros((2, 9), np.float32))
        assert code == 400 and "shape" in err["error"]
        code, err = _predict(base, "nope", x)
        assert code == 503 and err["reason"] == "no_replica"
        code, body = _get(base, "/readyz")
        assert code == 200 and body["replicas"] == ["repA", "repB"]
        code, body = _get(base, "/v1/fleet")
        assert code == 200 and sorted(body["replicas"]) == ["repA", "repB"]
    finally:
        if router is not None:
            router.stop()
        rep_a.stop(drain_timeout_s=5.0)
        rep_b.stop(drain_timeout_s=5.0)


def test_restore_and_serve_never_routed_while_cold(tmp_path):
    """A replica restored from a checkpoint is announced cold and never
    routed to until its lease says warmed; its shape guard is seeded from
    the conf, so a fresh replica answers a wrong shape 400 before dispatch.
    ``restore_and_serve`` serves the checkpoint's weights and refuses by
    name what the port has no counterpart for."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    net = _net(3)
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt, async_write=False, device="cpu").save(net)
    store = ObjectStoreBackend()
    rep = restore_and_serve(store, [("m", ckpt)], replica_id="warm0", device="cpu",
                            wait_ready_s=60)
    srv = ModelServer()
    restored = CheckpointManager(ckpt, device="cpu").restore_latest(load_updater=False)
    ep = srv.add_model("m", restored)
    cold = ServingReplica(srv, store, "cold0", heartbeat_s=0.5)
    cold.start(warm=False)
    assert ep.feature_shape == (4,)
    rep.stop(drain_timeout_s=5.0)  # only the cold replica is left
    router = FleetRouter(FleetView(store), refresh_s=0.05, seed=0).start()
    try:
        x = np.arange(16, dtype=np.float32).reshape(4, 4) / 16
        code, err = _predict(router.address, "m", x)
        assert code == 503 and err["reason"] == "no_replica"
        cold.mark_ready()
        deadline = time.monotonic() + 15.0
        code, out = None, None
        while time.monotonic() < deadline:
            code, out = _predict(router.address, "m", x)
            if code == 200:
                break
            time.sleep(0.05)
        assert code == 200
        np.testing.assert_array_equal(np.asarray(out["outputs"], np.float32),
                                      net.output(x).numpy())
        code, err = _predict(router.address, "m", np.zeros((2, 9), np.float32))
        assert code == 400 and "shape" in err["error"]
    finally:
        router.stop()
        cold.stop(drain_timeout_s=5.0)
    with pytest.raises(NotImplementedError, match="compile"):
        restore_and_serve(store, [("m", ckpt)], device="cpu", compile_cache_dir=str(tmp_path))
    with pytest.raises(ValueError, match="calibration record"):
        restore_and_serve(store, [("m", ckpt)], device="cpu", weight_bits=4)


def test_router_retries_transient_against_different_replica():
    store = ObjectStoreBackend()
    srv = ModelServer()
    srv.add_model("m", _net(2), warmup_example=np.zeros((1, 4), np.float32))
    rep = ServingReplica(srv, store, "live0", heartbeat_s=0.5).start()
    router = None
    try:
        assert rep.wait_ready(120)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        dead = ReplicaAnnouncer(store, "dead0", address=f"http://127.0.0.1:{dead_port}",
                                models=["m"], heartbeat_s=999.0)
        dead.announce()
        dead.set_warmed(True)
        router = FleetRouter(FleetView(store), refresh_s=0.05, quarantine_s=0.0,
                             backoff_base_s=0.0, backoff_cap_s=0.001, seed=0).start()
        retries0 = router._m_retries.value
        for _ in range(8):
            code, _ = _predict(router.address, "m", np.zeros((2, 4), np.float32))
            assert code == 200
        assert router._m_retries.value > retries0
    finally:
        if router is not None:
            router.stop()
        rep.stop(drain_timeout_s=5.0)


def _half_open_sink():
    """A fake replica that reads the request and closes with no answer."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    hits = []

    def loop():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            hits.append(1)
            try:
                c.settimeout(2.0)
                c.recv(65536)
            except OSError:
                pass
            finally:
                c.close()

    threading.Thread(target=loop, daemon=True).start()
    return srv, srv.getsockname()[1], hits


def test_post_send_failure_never_retries_non_idempotent():
    sink_a, port_a, hits_a = _half_open_sink()
    sink_b, port_b, hits_b = _half_open_sink()
    store = ObjectStoreBackend()
    try:
        for rid, port in (("a", port_a), ("b", port_b)):
            ann = ReplicaAnnouncer(store, rid, address=f"http://127.0.0.1:{port}",
                                   models=["m"], heartbeat_s=999.0)
            ann.announce()
            ann.set_warmed(True)
        router = FleetRouter(FleetView(store), quarantine_s=0.0, backoff_base_s=0.0,
                             backoff_cap_s=0.001, request_timeout_s=5.0, seed=0)
        up = router._forward("model", "m", "POST", "/v1/models/m:predict", b"{}",
                             "application/json", idempotent=False)
        assert up.status == 502 and json.loads(up.body)["reason"] == "upstream_failed"
        assert len(hits_a) + len(hits_b) == 1
        up = router._forward("model", "m", "POST", "/v1/models/m:predict", b"{}",
                             "application/json", idempotent=True)
        assert up.status == 503
        assert len(hits_a) + len(hits_b) == 3 and hits_a and hits_b
    finally:
        sink_a.close()
        sink_b.close()


# ------------------------------------------------------------- autoscaler
def _prom(shed, served, inflight, buckets):
    lines = ["# fake scrape", f"serving_requests_shed {shed}",
             f"serving_http_requests {served}", f"serving_inflight_requests {inflight}"]
    total = 0
    for le, cum in buckets:
        lines.append(f'serving_request_ms_bucket{{le="{le}"}} {cum}')
        total = cum
    lines.append(f'serving_request_ms_bucket{{le="+Inf"}} {total}')
    lines.append(f"serving_request_ms_sum {float(total)}")
    lines.append(f"serving_request_ms_count {total}")
    return "\n".join(lines)


def test_parse_prometheus_and_histogram_quantile_equal_jax():
    from deeplearning4j_tpu.fleet.autoscaler import histogram_quantile as jq
    from deeplearning4j_tpu.fleet.autoscaler import parse_prometheus as jparse
    text = _prom(2, 10, 3, [(10, 5), (50, 9)])
    got = parse_prometheus(text)
    assert got == jparse(text)
    h = got["serving_request_ms"]
    assert h["buckets"] == [(10.0, 5.0), (50.0, 9.0), (float("inf"), 9.0)]
    assert h["count"] == 9 and h["sum"] == 9.0
    assert histogram_quantile(h["buckets"], 0.5) == pytest.approx(9.0)
    assert histogram_quantile(h["buckets"], 0.999) == pytest.approx(49.91)
    inf_heavy = [(10.0, 5.0), (50.0, 9.0), (float("inf"), 12.0)]
    assert histogram_quantile(inf_heavy, 0.99) == pytest.approx(50.0)
    assert histogram_quantile([], 0.5) == 0.0
    for b in (h["buckets"], inf_heavy):
        for q in (0.1, 0.5, 0.9, 0.99):
            assert histogram_quantile(b, q) == jq(b, q)


def test_autoscaler_slo_decisions_and_cooldowns():
    store = ObjectStoreBackend()
    t = {"now": 0.0}
    metrics = {}

    class Launcher:
        def __init__(self):
            self.started, self.stopped = 0, []

        def start_replica(self):
            self.started += 1
            return f"new{self.started}"

        def stop_replica(self, rid):
            self.stopped.append(rid)

    def announce(rid, port, inflight):
        ann = ReplicaAnnouncer(store, rid, address=f"http://127.0.0.1:{port}",
                               models=["m"], heartbeat_s=999.0,
                               load_fn=lambda: {"inflight": inflight})
        ann.announce()
        ann.set_warmed(True)
        return ann

    launcher = Launcher()
    pol = AutoscalerPolicy(min_replicas=1, max_replicas=3, scale_up_cooldown_s=10.0,
                           scale_down_cooldown_s=30.0)
    scaler = Autoscaler(FleetView(store, ttl_s=1e9), launcher, pol,
                        fetch=lambda addr: metrics[addr], clock=lambda: t["now"])
    assert scaler.step()["action"] == "up" and launcher.started == 1
    a0 = "http://127.0.0.1:1"
    announce("rep0", 1, inflight=3)
    metrics[a0] = _prom(0, 100, 1.0, [(10, 100), (1000, 100)])
    t["now"] = 12.0
    assert scaler.step()["action"] == "hold"
    t["now"] = 24.0
    metrics[a0] = _prom(30, 160, 1.0, [(10, 160), (1000, 160)])
    d = scaler.step()
    assert (d["action"], d["reason"]) == ("up", "slo breach: shed")
    assert d["shed_rate"] == pytest.approx(30 / 90) and launcher.started == 2
    t["now"] = 26.0
    metrics[a0] = _prom(40, 180, 1.0, [(10, 180), (1000, 180)])
    d = scaler.step()
    assert d["action"] == "hold" and "cooldown" in d["reason"]
    announce("rep1", 2, inflight=0)
    metrics["http://127.0.0.1:2"] = _prom(0, 0, 0.0, [(10, 0), (1000, 0)])
    t["now"] = 41.0
    metrics[a0] = _prom(40, 400, 1.0, [(10, 180), (1000, 400)])
    d = scaler.step()
    assert (d["action"], d["reason"]) == ("up", "slo breach: p99")
    assert d["p99_ms"] > pol.target_p99_ms
    t["now"] = 120.0
    d = scaler.step()
    assert (d["action"], d["victim"]) == ("down", "rep1") and launcher.stopped == ["rep1"]
    t["now"] = 125.0
    d = scaler.step()
    assert d["action"] == "hold" and "cooldown" in d["reason"]


def test_scale_down_victim_is_placement_safe():
    from deeplearning4j_tpu_torch.fleet.membership import ReplicaInfo

    def info(rid, models, indexes, inflight):
        return ReplicaInfo(replica_id=rid, address="http://x:1", warmed=True, draining=False,
                           models=tuple(models), indexes=tuple(indexes), incarnation="i",
                           load={"inflight": inflight}, time=0.0)

    scaler = Autoscaler(FleetView(ObjectStoreBackend()), launcher=None, fetch=lambda a: "")
    assert scaler._victim({"lo": info("lo", ["a"], [], 0), "hi": info("hi", ["a"], [], 9)}) \
        == "lo"
    assert scaler._victim({"lo": info("lo", ["a", "b"], [], 0),
                           "hi": info("hi", ["a"], [], 9)}) == "hi"
    assert scaler._victim({"lo": info("lo", ["a"], ["vecs"], 0),
                           "hi": info("hi", ["a"], [], 9)}) == "hi"
    assert scaler._victim({"lo": info("lo", ["a"], [], 0)}) is None


# ------------------------------------------------------------------- CLI
def test_fleet_cli_parser_accepts_the_tools_fleet_arguments():
    import importlib.util

    from deeplearning4j_tpu_torch.fleet.__main__ import build_parser
    spec = importlib.util.spec_from_file_location("fleet_cli",
                                                  os.path.join(REPO, "tools", "fleet.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    for argv in (["up", "--store", "/tmp/s", "--replicas", "3", "--model", "iris=/ckpts/iris",
                  "--model", "big=/ckpts/big"],
                 ["replica", "--store", "/tmp/s", "--model", "m=/c", "--replica-id", "r1",
                  "--ttl-s", "3.0", "--drain-timeout-s", "30"],
                 ["router", "--store", "/tmp/s", "--port", "9300"], ["smoke"]):
        want = vars(cli.build_parser().parse_args(argv))
        got = vars(build_parser().parse_args(argv))
        assert {k: got[k] for k in want} == want, argv
    args = build_parser().parse_args(["up", "--store", "/tmp/s", "--model", "iris=/c",
                                      "--weight-bits", "4", "--device", "cpu"])
    assert args.weight_bits == 4 and args.device == "cpu"
    for bad in (["up", "--store", "/tmp/s", "--model", "no-equals-sign"],):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)


# ----------------------------------------------------------- across packages
def _integer_nets(tmp_path):
    """A JAX net with small-integer weights (identity activations) and the
    port's restore of its zip: both packages' products are exact."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf import InputType as JInputType
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.utils import serialization as jser
    from deeplearning4j_tpu_torch.utils.serialization import restore
    conf = (JNNC.builder().seed(5).weight_init("xavier").list()
            .layer(JDense(n_out=6, activation="identity"))
            .layer(JOutput(n_out=3, activation="identity", loss="mse"))
            .set_input_type(JInputType.feed_forward(4)).build())
    jnet = JMLN(conf).init()
    jnet.params = jax.tree_util.tree_map(lambda a: jnp.round(a * 8.0), jnet.params)
    path = str(tmp_path / "ints.zip")
    jser.write_model(jnet, path)
    return jnet, restore(path, device="cpu")


def test_port_router_fronts_a_jax_and_a_port_replica_with_identical_bodies(tmp_path):
    from deeplearning4j_tpu.fleet import ServingReplica as JReplica
    from deeplearning4j_tpu.serving import ModelServer as JServer
    jnet, pnet = _integer_nets(tmp_path)
    store = str(tmp_path / "leases")
    os.makedirs(store)
    example = np.zeros((1, 4), np.float32)
    jsrv = JServer()
    jsrv.add_model("ints", jnet, warmup_example=example)
    psrv = ModelServer()
    psrv.add_model("ints", pnet, warmup_example=example)
    jrep = JReplica(jsrv, store, "jax0", heartbeat_s=0.5).start()
    prep = ServingReplica(psrv, store, "port0", heartbeat_s=0.5).start()
    router = None
    try:
        assert jrep.wait_ready(120) and prep.wait_ready(120)
        router = FleetRouter(FleetView(store), refresh_s=0.1, seed=1).start()
        assert sorted(router.table()) == ["jax0", "port0"]
        rng = np.random.default_rng(0)
        before = [s._m_requests.value for s in (jsrv, psrv)]
        for i in range(12):
            x = rng.integers(-3, 4, (1 + i % 3, 4)).astype(np.float32)
            body = {"inputs": x.tolist()}
            code, routed = _post_raw(router.address, "/v1/models/ints:predict", body)
            codes = [_post_raw(s.address, "/v1/models/ints:predict", body)
                     for s in (jsrv, psrv)]
            assert code == 200 and [c for c, _ in codes] == [200, 200]
            assert codes[0][1] == codes[1][1] == routed, (codes, routed)
        # both replicas took routed requests (each also took the 12 direct)
        routed_to = [s._m_requests.value - b - 12 for s, b in zip((jsrv, psrv), before)]
        assert sum(routed_to) == 12 and min(routed_to) >= 1, routed_to
        code, body = _get(router.address, "/v1/models")
        assert code == 200 and body["placement"] == {"ints": ["jax0", "port0"]}
    finally:
        if router is not None:
            router.stop()
        jrep.stop(drain_timeout_s=5.0)
        prep.stop(drain_timeout_s=5.0)
