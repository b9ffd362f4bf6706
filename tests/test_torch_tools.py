"""The port's offline CLIs (``deeplearning4j_tpu_torch/tools/``) held to the
JAX package's ``tools/`` scripts, on the CPU.

Each parser has the JAX tool's options and defaults, plus ``--device``
where it touches tensors; without a card and without ``--device cpu`` a
tool raises. ``obs_report`` prints the JAX tool's text byte for byte on
the same inputs; ``lake`` lists and moves the same objects; the
``build_index`` ``.npz`` of each package loads in the other's
``load_index`` with the same top-k ids; the JAX package's ``restore``
reads the port's ``quantize`` output and predicts within 1e-6 of the
port's prediction on it (the same int8 arithmetic, float32 requantize);
``autotune``'s record reads in both packages. Inputs come from fixed
seeds.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import retrieval as jr
from deeplearning4j_tpu.checkpoint.storage import LocalFSBackend as JaxLocalFS
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.obs import flight as jflight
from deeplearning4j_tpu.perf.autotune import TuningRecord as JaxTuningRecord
from deeplearning4j_tpu.utils import serialization as jser

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch import retrieval as pr
from deeplearning4j_tpu_torch.checkpoint.storage import LocalFSBackend
from deeplearning4j_tpu_torch.obs.flight import FlightRecorder
from deeplearning4j_tpu_torch.perf.autotune import TuningRecord
from deeplearning4j_tpu_torch.tools import (autotune, build_index, lake, obs_report,
                                            quantize, run_lint)
from deeplearning4j_tpu_torch.utils import serialization as pser

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANT_ATOL = 1e-6


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO_ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _options(parser):
    """{option strings: (dest, default, type, choices, required, nargs)},
    subcommands by name."""
    out = {}
    for a in parser._actions:
        if a.option_strings:
            out[tuple(a.option_strings)] = (a.dest, a.default, a.type, a.choices,
                                            a.required, a.nargs, a.const)
        elif a.choices and isinstance(a.choices, dict):
            for cmd, sub in a.choices.items():
                out[cmd] = _options(sub)
        else:
            out[a.dest] = (a.default, a.nargs)
    return out


def _run(main, argv):
    """(exit code, stdout) of one tool's main(argv) in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ---------------------------------------------------------------- parsers
@pytest.mark.parametrize("name,mod,device", [
    ("build_index", build_index, True), ("quantize", quantize, True),
    ("autotune", autotune, True), ("lake", lake, False)])
def test_parser_matches_the_jax_tool(name, mod, device):
    jax_opts = _options(_jax_tool(name).build_parser())
    port_opts = _options(mod.build_parser())
    if device:
        dev = port_opts.pop(("--device",))
        assert dev[:2] == ("device", None)
    assert port_opts == jax_opts


@pytest.mark.parametrize("argv", [
    ["--vectors", "random:64x8", "--kind", "brute"],
    ["--ckpt", "x.zip", "--out", "y.zip", "--data", "random:4"],
    ["--model", "zoo:lenet", "--out", "t.json", "--batch-sizes", "2"],
], ids=["build_index", "quantize", "autotune"])
def test_tools_run_on_the_card_unless_told(argv, tmp_path):
    main = {"--vectors": build_index, "--ckpt": quantize, "--model": autotune}[argv[0]].main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([a.replace("x.zip", str(tmp_path / "x.zip")) for a in argv])


# ------------------------------------------------------------- obs_report
@pytest.fixture()
def obs_logs(tmp_path):
    """An event log and a flight dump the port's obs wrote: spans, one
    event, the dump flushed on a fault."""
    ticks = iter(np.arange(0.0, 10.0, 0.0037).tolist())
    backend = LocalFSBackend(str(tmp_path))
    tracer = obs.Tracer(enabled=True, clock=lambda: next(ticks),
                        registry=obs.MetricsRegistry())
    ring = FlightRecorder(capacity=6, store=backend, worker_id="w3")
    elog = obs.EventLog(backend, name="events.jsonl", flush_every=1000)
    tracer.add_sink(ring)
    tracer.add_sink(elog)
    for i in range(5):
        with tracer.span("train.step_host", step=i):
            pass
        with tracer.span("train.data_wait", step=i):
            pass
    with tracer.span("checkpoint.commit", step=4, bytes=1234):
        pass
    tracer.event("generation.boundary", gen=2)
    assert elog.flush()
    assert ring.flush("fault injection: test") == "flightrec-w3"
    return [str(tmp_path / "events.jsonl"), str(tmp_path / "flightrec-w3")]


@pytest.mark.parametrize("args", [[], ["--top", "3"]], ids=["default", "top3"])
def test_obs_report_text_is_the_jax_tools(obs_logs, args):
    jrc, jtext = _run(_jax_tool("obs_report").main, ["obs_report.py"] + obs_logs + args)
    prc, ptext = _run(obs_report.main, ["obs_report"] + obs_logs + args)
    assert jrc == prc == 0
    assert ptext == jtext
    assert "Crash-ring tail — worker w3 (flushed: fault injection: test)" in ptext
    dump = jflight.latest_dump(JaxLocalFS(os.path.dirname(obs_logs[0])))
    assert len(dump["events"]) == 6


def test_obs_report_usage_exit_codes():
    assert _run(obs_report.main, ["obs_report"])[0] == \
        _run(_jax_tool("obs_report").main, ["obs_report.py"])[0] == 2


# ------------------------------------------------------------------- lake
def test_lake_lists_and_moves_the_same_objects(tmp_path, capsys):
    blob = tmp_path / "blob.bin"
    blob.write_bytes(np.arange(1000, dtype=np.int32).tobytes())
    seen = {}
    for pkg, main in (("jax", _jax_tool("lake").main), ("port", lake.main)):
        url = "file:" + str(tmp_path / f"store_{pkg}")
        assert main(["put", url, "shards/a.bin", "--in", str(blob)]) == 0
        assert main(["put", url, "meta.json", "--in", str(blob)]) == 0
        capsys.readouterr()
        assert main(["ls", url, "--prefix", "shards/"]) == 0
        listing = capsys.readouterr().out
        assert main(["ls", url, "-l"]) == 0
        long = capsys.readouterr().out
        out = tmp_path / f"{pkg}.bin"
        assert main(["get", url, "shards/a.bin", "--out", str(out)]) == 0
        assert main(["gc", url]) == 0
        capsys.readouterr()
        seen[pkg] = (listing, long, out.read_bytes(),
                     sorted(os.listdir(tmp_path / f"store_{pkg}")))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0].split() == ["shards/a.bin"]
    assert seen["port"][2] == blob.read_bytes()


# ------------------------------------------------------------ build_index
@pytest.mark.parametrize("flags", [
    ["--kind", "ivf", "--n-cells", "8", "--nprobe", "3"],
    ["--kind", "brute", "--int4"],
    ["--kind", "ivf", "--pq", "4", "--ksub", "16", "--n-cells", "8", "--nprobe", "3"],
], ids=["ivf", "brute_int4", "ivf_pq"])
def test_build_index_npz_crosses_both_ways(flags, tmp_path):
    V, Q = pr.synthetic_corpus(1500, 16, n_clusters=12, seed=0, queries=12)
    vec = tmp_path / "v.npy"
    np.save(vec, V)
    jout, pout = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jrc, jtext = _run(_jax_tool("build_index").main,
                      ["--vectors", str(vec), *flags, "--out", jout])
    prc, ptext = _run(build_index.main,
                      ["--vectors", str(vec), *flags, "--out", pout, "--device", "cpu"])
    assert jrc == prc == 0
    jbuilt = json.loads(jtext.splitlines()[0])["built"]
    pbuilt = json.loads(ptext.splitlines()[0])["built"]
    for key in ("kind", "size", "dim", "codec"):
        assert pbuilt[key] == jbuilt[key], key
    jix, pix = jr.load_index(jout), pr.load_index(jout, device="cpu")
    assert np.array_equal(pix.search(Q, 5)[0], jix.search(Q, 5)[0])
    jback, pown = jr.load_index(pout), pr.load_index(pout, device="cpu")
    assert np.array_equal(jback.search(Q, 5)[0], pown.search(Q, 5)[0])


def test_build_index_gate_load_and_exit_codes(tmp_path):
    vec = tmp_path / "v.npy"
    np.save(vec, pr.synthetic_corpus(800, 8, seed=1))
    out = str(tmp_path / "i.npz")
    rc, text = _run(build_index.main, ["--vectors", str(vec), "--kind", "ivf", "--n-cells", "4",
                                       "--nprobe", "4", "--gate-min-recall", "0.9",
                                       "--out", out, "--device", "cpu"])
    assert rc == 0 and json.loads(text.splitlines()[0])["recall_gate"]["recall"] >= 0.9
    rc, text = _run(build_index.main, ["--load", out, "--query-random", "2", "--device", "cpu"])
    assert rc == 0 and len(json.loads(text.splitlines()[1])["query_smoke"]["indices"]) == 2
    jmain = _jax_tool("build_index").main
    for argv in (["--kind", "brute"], ["--vectors", str(vec), "--int8", "--int4"],
                 ["--vectors", str(vec), "--kind", "brute", "--csr"]):
        assert _run(build_index.main, argv + ["--device", "cpu"])[0] == \
            _run(jmain, argv)[0] == 2
    rc = _run(build_index.main, ["--vectors", str(vec), "--kind", "ivf", "--n-cells", "40",
                                 "--nprobe", "1", "--gate-min-recall", "0.99",
                                 "--device", "cpu"])[0]
    assert rc == 1


# --------------------------------------------------------------- quantize
def test_quantize_output_restores_in_the_jax_package(tmp_path):
    conf = (JaxNNC.builder().seed(3).weight_init("xavier").list()
            .layer(jl.DenseLayer(n_out=16, activation="relu"))
            .layer(jl.DenseLayer(n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(6)).build())
    src = str(tmp_path / "fp32.zip")
    jser.write_model(JaxNet(conf).init(), src)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    data = str(tmp_path / "calib.npz")
    np.savez(data, x=x, y=np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)])
    reports = {}
    for pkg, main, extra in (("jax", _jax_tool("quantize").main, []),
                             ("port", quantize.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{pkg}.zip")
        rc, _ = _run(main, ["--ckpt", src, "--out", out, "--data", data, "--batches", "2",
                            "--batch-size", "32", "--eval", *extra])
        assert rc == 0
        with open(out + ".report.json", encoding="utf-8") as f:
            reports[pkg] = json.load(f)
    assert len(reports["port"]["quantized_layers"]) == 3
    for key in ("quantized_layers", "calibration_batches", "observer", "fp32_param_bytes",
                "quantized_param_bytes", "byte_reduction_x"):
        assert reports["port"][key] == reports["jax"][key], key
    for layer, entry in reports["jax"]["ranges"].items():
        for field, want in entry.items():
            assert reports["port"]["ranges"][layer][field] == pytest.approx(want, rel=1e-5)
    jq = jser.restore(str(tmp_path / "port.zip"))
    pq = pser.restore(str(tmp_path / "port.zip"), device="cpu")
    want = pq.output(torch.from_numpy(x)).numpy()
    got = np.asarray(jq.output(x))
    assert got.shape == want.shape == (64, 3)
    np.testing.assert_allclose(got, want, atol=QUANT_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jser.restore(str(tmp_path / "jax.zip")).output(x)),
                               want, atol=QUANT_ATOL, rtol=0)


# --------------------------------------------------------------- autotune
def test_autotune_record_reads_in_both_packages(tmp_path):
    out = str(tmp_path / "tuning.json")
    rc, text = _run(autotune.main, ["--model", "zoo:lenet", "--out", out, "--batch-sizes",
                                    "2,4", "--top-k", "1", "--reps", "1",
                                    "--no-donation-search", "--fusion", "off",
                                    "--device", "cpu"])
    assert rc == 0 and json.loads(text)["batch_size"] in (2, 4)
    port_rec = TuningRecord.load(out)
    jax_rec = JaxTuningRecord.load(out)
    assert jax_rec.to_dict() == port_rec.to_dict()
    back = str(tmp_path / "jax.json")
    jax_rec.save(back)
    assert TuningRecord.load(back).to_dict() == port_rec.to_dict()


def test_autotune_plan_only(tmp_path):
    out = str(tmp_path / "t.json")
    rc, text = _run(autotune.main, ["--model", "zoo:lenet", "--out", out, "--batch-sizes", "4",
                                    "--budget", "64M", "--plan-only", "--device", "cpu"])
    assert rc == 0 and text.strip() and not os.path.exists(out)
    with pytest.raises(SystemExit):
        autotune.main(["--model", "zoo:lenet", "--out", out, "--plan-only", "--device", "cpu"])
    assert autotune.parse_bytes("1.5K") == _jax_tool("autotune").parse_bytes("1.5K") == 1536


# ---------------------------------------------------------------- run_lint
def test_run_lint_module_entry_point():
    """``python -m deeplearning4j_tpu_torch.tools.run_lint``: the JSON
    schema and exit code of the JAX tool on the same fixture."""
    fix = os.path.join(REPO_ROOT, "tests", "lint_fixtures", "lockpair_pkg")
    proc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.tools.run_lint",
                           "--json", "--rule", "DLT018", fix], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    jrc, jtext = _run(_jax_tool("run_lint").main, ["run_lint.py", "--json", "--rule",
                                                   "DLT018", fix])
    assert proc.returncode == jrc == 1
    assert json.loads(proc.stdout) == json.loads(jtext)
    assert run_lint.main(["run_lint", "--rule", "DLT0"]) == 2
