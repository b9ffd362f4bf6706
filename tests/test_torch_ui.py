"""The port's training UI (``ui/``) against the JAX package's, on the CPU:

- the StatsListener's statistics of the same arrays (reduced as one flat
  float64 group a device in the port, on the host in the JAX package):
  histogram counts, min and max exactly equal, moments within 1e-12 of the
  leaf's largest magnitude, non-finite, empty and constant leaves included;
- a short MultiLayerNetwork fit under each package's listener, the weights
  carried across by ``interop``: the same record keys, activations
  included; a graph's records carry none;
- every GET route of each package's ``UIServer`` over the same stats file
  gives the same answer; the dashboard pages differ only in the software
  line, which reads each package's own static record;
- component JSON round-trips across the packages and renders the same;
  the i18n messages are the same; ``python -m deeplearning4j_tpu_torch.ui``
  serves a stats file.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
from deeplearning4j_tpu.storage import FileStatsStorage as JFile
from deeplearning4j_tpu.storage import InMemoryStatsStorage as JMemory
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import i18n as ji18n
from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu.ui import stats as jstats

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.storage import FileStatsStorage, InMemoryStatsStorage
from deeplearning4j_tpu_torch.ui import components as pcomp
from deeplearning4j_tpu_torch.ui import i18n as pi18n
from deeplearning4j_tpu_torch.ui import server as pserver
from deeplearning4j_tpu_torch.ui import stats as pstats

BINS = 20
MOMENT_LIMIT = 1e-12  # of the leaf's largest finite magnitude
_RNG = np.random.default_rng(0)
LEAVES = {
    "normal_f32": _RNG.standard_normal(1000).astype(np.float32),
    "wide_f64": _RNG.standard_normal((30, 40)) * 1e3 + 5.0,
    "non_finite": np.array([1.0, np.nan, -np.inf, 2.5, np.inf, -3.0], np.float32),
    "all_nan": np.array([np.nan, np.nan], np.float32),
    "empty": np.zeros((0, 3), np.float32),
    "constant": np.full(7, 0.25, np.float32),
    "large_constant": np.full(5, 1e5),  # lo + 1e-12 == lo: numpy's outer edges
    "single": np.array([3.0], np.float32),
    "on_the_edges": np.linspace(-1.0, 1.0, BINS + 1),
    "integers": np.arange(-7, 50, dtype=np.int64),
    "near_zero_mean": (_RNG.standard_normal(4096) * 1e-3).astype(np.float32),
}


def _hold(got, arr):
    want = {**jstats._stats_of(arr), "histogram": jstats._histogram(arr, BINS)}
    assert got["histogram"] == want["histogram"]
    fin = np.abs(np.asarray(arr, np.float64)[np.isfinite(arr)])
    mag = float(fin.max()) if fin.size else 0.0
    for k in ("mean", "stdev", "mean_magnitude"):
        assert abs(got[k] - want[k]) <= MOMENT_LIMIT * mag, (k, got[k], want[k])


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_leaf_statistics_match_the_jax_listener(name):
    arr = LEAVES[name]
    got = {**pstats._stats_of(torch.as_tensor(arr)),
           "histogram": pstats._histogram(torch.as_tensor(arr), BINS)}
    _hold(got, arr)


def test_one_group_reduces_every_leaf_apart():
    """All the leaves in one flat group: no segment bleeds into the next."""
    got = pstats.reduce_leaves({k: torch.as_tensor(v) for k, v in LEAVES.items()}, BINS)
    for name, arr in LEAVES.items():
        _hold(got[name], arr)
    only_hist = pstats.reduce_leaves({"a": torch.ones(3)}, BINS, moments=False)
    assert set(only_hist["a"]) == {"histogram"}
    assert pstats.reduce_leaves({"a": torch.ones(3)}, BINS, False, False) == {"a": {}}


def _jax_mln():
    conf = (JNNC.builder().seed(3).updater(JSgd(learning_rate=0.1)).weight_init("xavier")
            .list().layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    return JMLN(conf).init()


def _toy(n=24):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _keys(d):
    """Nested key paths of a record (leaf names and histogram counts kept
    as keys, values dropped)."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{s}" for s in _keys(v)}
    return out


@pytest.fixture(scope="module")
def fitted_records():
    """(JAX records, port records, port static): 3 steps under each
    package's listener from the same weights."""
    x, y = _toy()
    jnet = _jax_mln()
    storage = JMemory()
    jnet.set_listeners(jstats.StatsListener(storage, session_id="s", worker_id="w"))
    net = MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    net.set_params(params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                    for p in jnet.params], device="cpu"))
    pst = InMemoryStatsStorage()
    net.set_listeners(pstats.StatsListener(pst, session_id="s", worker_id="w"))
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
    return (storage.get_all_updates("s", "StatsListener"),
            pst.get_all_updates("s", "StatsListener"),
            pst.get_static_info("s", "StatsListener"),
            storage.get_static_info("s", "StatsListener"))


def test_short_mln_fit_gives_the_same_record_keys(fitted_records):
    jrecs, precs, pstatic, jstatic = fitted_records
    assert len(jrecs) == len(precs) == 3
    for j, p in zip(jrecs, precs):
        assert _keys(p) == _keys(j)
        assert p["iteration"] == j["iteration"]
        assert {"parameters", "activations", "memory"} <= set(p)
    assert "updates" not in precs[0] and "update_ratios" in precs[1]
    assert set(pstatic) == set(jstatic)
    assert pstatic["model"] == jstatic["model"]
    # the software and hardware records name the port's runtime
    assert set(pstatic["software"]) == {"python", "torch", "cuda", "hostname"}
    assert pstatic["software"]["torch"] == torch.__version__
    assert pstatic["hardware"] == {"device_kind": "cpu", "device_count": 1, "platform": "cpu"}
    # the same weights, one step: the parameters' statistics agree closely
    for name, want in jrecs[0]["parameters"].items():
        got = precs[0]["parameters"][name]
        np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-6)
        assert sum(got["histogram"]["counts"]) == sum(want["histogram"]["counts"])


def test_graph_records_carry_no_activations():
    """A ComputationGraph has no feed_forward, in either package; on the CPU
    the memory record has no device fields."""
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = pgraph.ComputationGraphConfiguration(
        network_inputs=("in",),
        vertices={"d": (DenseLayer(n_out=5, activation="relu"), ("in",)),
                  "out": (OutputLayer(n_out=3, activation="softmax", loss="mcxent"), ("d",))},
        network_outputs=("out",), input_types=(InputType.feed_forward(4),))
    net = ComputationGraph(conf, device="cpu").init()
    st = InMemoryStatsStorage()
    net.set_listeners(pstats.StatsListener(st, session_id="g"))
    x, y = _toy()
    net.fit(DataSet(x, y))
    rec = st.get_all_updates("g", "StatsListener")[0]
    assert "activations" not in rec
    assert set(rec["memory"]) == {"host_rss_bytes"}
    assert set(rec["parameters"]) == {"d_W", "d_b", "out_W", "out_b"}


# ------------------------------------------------------------------ server
@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both packages' UIServers over the same stats file (written by the
    port's listener), each with the same t-SNE upload."""
    path = str(tmp_path_factory.mktemp("ui") / "stats.jsonl")
    st = FileStatsStorage(path)
    x, y = _toy()
    net = MultiLayerNetwork(conf_from_jax_json(_jax_mln().conf.to_json()), device="cpu").init()
    net.set_listeners(pstats.StatsListener(st, session_id="sess", worker_id="w0"))
    for _ in range(2):
        net.fit(DataSet(x, y))
    st.put_update({"kind": "update", "session_id": "sess", "type_id": "ActivationsListener",
                   "worker_id": "w0", "timestamp": 1.0, "iteration": 0, "layers": {}})
    st.close()
    coords = np.random.default_rng(2).standard_normal((6, 2))
    out = {}
    for name, mod, storage in (("jax", jserver, JFile(path)),
                               ("torch", pserver, FileStatsStorage(path))):
        srv = mod.UIServer(0, "127.0.0.1").attach(storage)
        srv.upload_tsne("t", coords, labels=list("abcabc"))
        out[name] = f"http://127.0.0.1:{srv.port}"
        out[name + "_server"] = srv
    yield out
    out["jax_server"].stop()
    out["torch_server"].stop()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("route", [
    "/api/sessions", "/api/static?session=sess", "/api/updates?session=sess",
    "/api/static?session=missing", "/api/activations/sessions",
    "/api/activations/data?session=sess", "/api/tsne/sessions", "/api/tsne/data?session=t",
    "/api/tsne/data?session=missing", "/api/i18n", "/api/i18n?lang=de",
    "/api/i18n?lang=tlh", "/no/such/route", "/tsne", "/activations"])
def test_get_routes_answer_alike(servers, route):
    got, want = _get(servers["torch"] + route), _get(servers["jax"] + route)
    assert got[:2] == want[:2]
    if "json" in got[1]:
        assert json.loads(got[2]) == json.loads(want[2])
    else:
        assert got[2] == want[2]


def test_updates_route_serves_the_port_records(servers):
    _, _, body = _get(servers["torch"] + "/api/updates?session=sess")
    recs = json.loads(body)
    assert [r["iteration"] for r in recs] == [0, 1]
    assert "activations" in recs[0] and "updates" in recs[1]


@pytest.mark.parametrize("route", ["/", "/train", "/train/overview"])
def test_dashboard_differs_only_in_the_software_line(servers, route):
    got, want = _get(servers["torch"] + route), _get(servers["jax"] + route)
    assert got[:2] == want[:2] == (200, "text/html; charset=utf-8")
    g, w = got[2].decode().splitlines(), want[2].decode().splitlines()
    diff = [(a, b) for a, b in zip(g, w) if a != b]
    assert len(g) == len(w) and len(diff) == 1
    assert "sw.torch" in diff[0][0] and "sw.cuda" in diff[0][0] and "sw.jax" in diff[0][1]
    assert pserver.dashboard_html().encode() == got[2]


def test_metrics_and_obs_routes_read_the_port_registry(servers):
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    code, ctype, body = _get(servers["torch"] + "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    assert "train_score" in body.decode()  # the listener published its records
    code, _, body = _get(servers["torch"] + "/api/obs")
    assert code == 200 and set(json.loads(body)) == set(get_registry().as_dict())


@pytest.mark.parametrize("path,body,code", [
    ("/remoteReceive", {"kind": "update", "session_id": "posted", "type_id": "StatsListener",
                        "worker_id": "w", "timestamp": 3.0, "iteration": 0}, 200),
    ("/remoteReceive", b"not json", 400),
    ("/api/tsne/upload", {"session": "u", "coords": [[0, 1], [2, 3]]}, 200),
    ("/api/tsne/upload", {"session": "u", "coords": [[0, float("nan")]]}, 400),
    ("/nope", {}, 404)])
def test_post_routes_answer_alike(servers, path, body, code):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    got = []
    for name in ("torch", "jax"):
        req = urllib.request.Request(servers[name] + path, data=data, method="POST")
        got.append(_get(req))
    assert got[0] == got[1] and got[0][0] == code


# ------------------------------------------------------- components, i18n
def _components(mod):
    c = mod
    comps = [
        c.ChartLine("loss", c.Style(width=300)).add_series(
            "train", [0, 1, 2, 3], [2.0, 1.2, 0.7, 0.4]).add_series(
            "val", [0, 1, 2, 3], [2.1, 1.5, 1.0, 0.9]),
        c.ChartScatter("embedding").add_series("pts", [1, 2, 3], [3, 1, 2]),
        c.ChartHistogram("weights").add_bin(-1, 0, 10).add_bin(0, 1, 30),
        c.ChartHorizontalBar("per-class F1").add_value("cat", 0.91).add_value("dog", 0.84),
        c.ChartStackedArea("phase time").set_x([0, 1, 2])
        .add_series("fwd", [1, 1.1, 1.0]).add_series("bwd", [2, 2.2, 2.1]),
        c.ChartTimeline("epochs").add_lane("worker0", [(0.0, 1.0, "e0"), (1.2, 2.0, "e1")]),
        c.ComponentTable(["metric", "value"]).add_row("accuracy", "0.97"),
        c.ComponentText("<b>summary</b>", c.Style(background="#fff")),
    ]
    comps.append(c.DecoratorAccordion("details", comps[0], comps[6], default_collapsed=False))
    comps.append(c.ComponentDiv(*comps[1:6]))
    return comps


@pytest.mark.parametrize("i", range(10))
def test_component_json_crosses_both_ways(i):
    jc, pc = _components(jcomp)[i], _components(pcomp)[i]
    assert pc.to_json() == jc.to_json()
    assert pc.render_html() == jc.render_html()
    from_j = pcomp.component_from_json(jc.to_json())
    from_p = jcomp.component_from_json(pc.to_json())
    assert from_j.to_dict() == jc.to_dict() and from_p.to_dict() == pc.to_dict()
    assert from_j.render_html() == from_p.render_html()


def test_render_page_and_i18n_alike():
    assert (pcomp.render_page(_components(pcomp), title="r")
            == jcomp.render_page(_components(jcomp), title="r"))
    p, j = pi18n.DefaultI18N.get_instance(), ji18n.DefaultI18N.get_instance()
    assert p.languages() == j.languages()
    for lang in p.languages() + [None, "xx"]:
        assert p.messages(lang) == j.messages(lang)
    assert p.get_message("train.pagetitle", "de") == "Trainings-UI"


def test_cli_serves_a_stats_file(tmp_path):
    path = tmp_path / "cli.jsonl"
    FileStatsStorage(str(path)).put_static_info(
        {"kind": "static", "session_id": "cli", "type_id": "StatsListener",
         "worker_id": "w", "timestamp": 0.0})
    proc = subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch.ui", "--file",
                             str(path), "--port", "0"], stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=os.getcwd()))
    try:
        line = proc.stdout.readline()
        assert line.startswith("UI server at http://localhost:")
        port = line.split("localhost:")[1].split("/")[0]
        code, _, body = _get(f"http://127.0.0.1:{port}/api/sessions")
        assert code == 200 and json.loads(body) == ["cli"]
    finally:
        proc.kill()
        proc.wait(timeout=30)
