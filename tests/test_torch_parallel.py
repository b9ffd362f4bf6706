"""The data-parallel tier of the PyTorch port at one rank, against the JAX
package, on the CPU.

- Meshes: ``make_mesh`` at one rank; ``tp_param_spec`` / ``tp_shardings``
  give the JAX package's specs leaf for leaf on zoo parameter trees (a 4x2
  mesh of ranks built by hand beside the JAX 8-device one).
- Sharding helpers bitwise the JAX package's (rows, files, the unequal
  shard error's message).
- ``ParallelWrapper`` at one rank against the JAX ``ParallelWrapper`` over
  its 8-device CPU mesh on the same global batches, 3 steps: a narrow
  MultiLayerNetwork with Sgd within 1e-5 and a graph with batch norm and
  Adam within 1e-4 (the 8-device all-reduce and batch statistics sum in
  another order; Adam's step is about lr in size whatever the gradient's
  roundoff, hence the looser limit). ``ClusterTrainer`` at one rank is
  bitwise ``fit``.
- Ragged batches, once-an-epoch listeners, ``TrainingStats``,
  ``EarlyStoppingParallelTrainer``, the watchdog's call / guard / sync,
  the CLI on a zip the JAX package wrote, and the named refusals (tp > 1,
  the bn kernels at a data world above 1, a mesh of several ranks where
  each rank works alone).

JAX is imported inside the tests, not at module top.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import data_parallel
from deeplearning4j_tpu_torch.parallel import (ClusterTrainer, CollectiveTimeoutError,
                                               CollectiveWatchdog,
                                               EarlyStoppingParallelTrainer,
                                               ParallelWrapper, TrainingStats)
from deeplearning4j_tpu_torch.parallel import mesh as pmesh
from deeplearning4j_tpu_torch.parallel import sharding as psh
from deeplearning4j_tpu_torch.utils import serialization as pser


def _xy(n, seed=0, n_in=4, n_out=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n_in)).astype(np.float32),
            np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)])


def _jax_mln(seed=7):
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.optimize.updaters import Sgd
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(learning_rate=0.1))
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _jax_bn_graph(seed=5):
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.graph import GraphBuilder
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    from deeplearning4j_tpu.optimize.updaters import Adam
    parent = NeuralNetConfiguration.builder().seed(seed).updater(Adam(0.01)).weight_init(
        "xavier")
    conf = (GraphBuilder(parent).add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("bn", BatchNormalization(), "d1")
            .add_layer("d2", DenseLayer(n_out=8, activation="relu"), "bn")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "d2")
            .set_outputs("out").set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf).init()


def _to_port(jnet, tmp_path, name="net.zip"):
    from deeplearning4j_tpu.utils import serialization as jser
    path = tmp_path / name
    jser.write_model(jnet, str(path))
    return pser.restore(str(path), device="cpu")


def _sorted_leaves(tree):
    from deeplearning4j_tpu_torch.parallel.compress import _leaves
    return [t.detach().numpy() for _, t in _leaves(tree)]


def _jleaves(tree):
    import jax
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


# ------------------------------------------------------------------ meshes
def test_mesh_at_one_rank_and_tp_specs_equal_jax():
    """The JAX ``tp_shardings`` reads only leaf shapes: it is handed the
    port's zoo parameter trees as shape structs."""
    import jax
    from deeplearning4j_tpu.parallel import mesh as jmesh
    from deeplearning4j_tpu_torch.models import LeNet, ResNet50, TextGenerationLSTM
    m = pmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.device == torch.device("cpu") and m.data_group is None
    with pytest.raises(ValueError):
        pmesh.make_mesh(tp=2, device="cpu")  # one rank
    with pytest.raises(pmesh.MultiRankMeshError):
        pmesh.make_mesh(devices=["cpu", "cpu"])
    jm = jmesh.make_mesh(tp=2)
    pm = pmesh.Mesh(np.arange(8).reshape(4, 2), torch.device("cpu"))
    assert pm.shape == dict(jm.shape)
    for net in (LeNet().init(device="cpu"), TextGenerationLSTM(units=16).init(device="cpu"),
                ResNet50(num_classes=10, input_shape=(32, 32, 3)).init(device="cpu")):
        shapes = _map_tree(net.params, lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                                      np.float32))
        jflat = jax.tree_util.tree_leaves(jmesh.tp_shardings(jm, shapes),
                                          is_leaf=lambda x: hasattr(x, "spec"))
        pflat = [s for _, s in _flat_shardings(pmesh.tp_shardings(pm, net.params))]
        assert len(pflat) == len(jflat) > 0
        assert [tuple(s.spec) for s in pflat] == [tuple(s.spec) for s in jflat]
        assert any("model" in s.spec for s in pflat)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(pmesh.shard_batch(m, x).numpy(), x)
    assert tuple(pmesh.data_sharding(pm, 3).spec) == tuple(jmesh.data_sharding(jm, 3).spec)
    assert tuple(pmesh.replicated(pm).spec) == tuple(jmesh.replicated(jm).spec)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _flat_shardings(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat_shardings(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flat_shardings(v, f"{prefix}/{i}"))
        return out
    return [(prefix, tree)]


def test_sharding_helpers_equal_jax(tmp_path):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.parallel import sharding as jsh
    x, y = _xy(12)
    for pi in range(3):
        p = psh.shard_dataset_rows(DataSet(x, y), pi, 3)
        j = jsh.shard_dataset_rows(JDataSet(x, y), pi, 3)
        np.testing.assert_array_equal(p.features, np.asarray(j.features))
        np.testing.assert_array_equal(p.labels, np.asarray(j.labels))
    p = [d.features for d in psh.shard_iterator([DataSet(x, y)] * 2, 1, 4)]
    j = [np.asarray(d.features) for d in jsh.shard_iterator([JDataSet(x, y)] * 2, 1, 4)]
    assert len(p) == len(j) == 2 and all(np.array_equal(a, b) for a, b in zip(p, j))
    names = [f"part-{i:03d}.csv" for i in (7, 2, 9, 0, 4)]
    for pi in range(2):
        assert psh.shard_files(names, pi, 2) == jsh.shard_files(names, pi, 2)
        assert psh.shard_files(names, pi, 2, sort=False) == jsh.shard_files(names, pi, 2,
                                                                            sort=False)
    for n in names:
        (tmp_path / n).write_text("x")
    assert psh.shard_directory(str(tmp_path), "*.csv", 1, 2) == jsh.shard_directory(
        str(tmp_path), "*.csv", 1, 2)
    with pytest.raises(psh.UnequalShardError) as pe:
        psh.check_equal_local_shards([4, 4, 3])
    with pytest.raises(jsh.UnequalShardError) as je:
        jsh.check_equal_local_shards([4, 4, 3])
    counts = "p0=4, p1=4, p2=3"
    assert counts in str(pe.value) and counts in str(je.value)
    psh.check_equal_local_shards([5, 5])
    with pytest.raises(ValueError, match="not divisible"):
        psh.shard_dataset_rows(DataSet(x, y), 0, 5)
    with pytest.raises(ValueError, match="out of range"):
        psh.shard_dataset_rows(DataSet(x, y), 3, 3)


# ------------------------------------------------------- training at world 1
@pytest.mark.parametrize("kind", ["mln_sgd", "graph_bn_adam"])
def test_parallel_wrapper_matches_jax_mesh(kind, tmp_path):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
    from deeplearning4j_tpu.parallel.trainer import ParallelWrapper as JPW
    jnet = _jax_mln() if kind == "mln_sgd" else _jax_bn_graph()
    pnet = _to_port(jnet, tmp_path)
    batches = [_xy(16, seed=s) for s in range(3)]
    JPW(jnet, mesh=jmake_mesh()).fit([JDataSet(x, y) for x, y in batches])
    pw = ParallelWrapper(pnet)
    assert pw.mesh.shape == {"data": 1, "model": 1}
    pw.fit([DataSet(x, y) for x, y in batches])
    atol = 1e-5 if kind == "mln_sgd" else 1e-4
    for a, b in zip(_sorted_leaves(pnet.params), _jleaves(jnet.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    for a, b in zip(_sorted_leaves(pnet.state), _jleaves(jnet.state)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    assert pnet.iteration == jnet.iteration == 3 and pnet.epoch == jnet.epoch == 1


def test_cluster_trainer_at_one_rank_is_fit_bitwise(tmp_path):
    from deeplearning4j_tpu_torch.checkpoint import sharded as pshd
    jnet = _jax_bn_graph()
    a, b = _to_port(jnet, tmp_path, "a.zip"), _to_port(jnet, tmp_path, "b.zip")
    data = [DataSet(*_xy(8, seed=s)) for s in range(3)]
    ClusterTrainer.initialize(num_processes=1)  # a no-op at one process
    ct = ClusterTrainer(a, collect_stats=True)
    ct.fit(data, num_epochs=2, prefetch=True)
    b.fit(data, num_epochs=2)
    assert pshd.state_sha(a) == pshd.state_sha(b)
    assert a.score() == b.score()
    assert ct.stats.minibatches == 6 and ct.stats.examples == 48
    assert set(ct.stats.key_set()) >= {"data_placement", "train_dispatch", "epoch_sync"}
    assert ct.score_local_shard(data[0]) == pytest.approx(b.score_dataset(data[0]))


def test_ragged_listeners_stats_and_early_stopping(tmp_path):
    from deeplearning4j_tpu_torch.earlystopping import (EarlyStoppingConfiguration,
                                                        MaxEpochsTerminationCondition)
    net = _to_port(_jax_mln(), tmp_path)
    # a hand-built 2-rank data axis: ragged decisions happen before any step
    pw2 = ParallelWrapper(net, mesh=pmesh.Mesh(np.arange(2).reshape(2, 1),
                                               torch.device("cpu")))
    with pytest.raises(ValueError, match="dropped as ragged"):
        pw2.fit([DataSet(*_xy(5)), DataSet(*_xy(7))])
    with pytest.raises(ValueError, match="not divisible"):
        pw2.fit(DataSet(*_xy(5)))
    assert not pw2.fit_batch(DataSet(*_xy(3)), drop_ragged=True)

    events = []

    class Rec:
        def iteration_done(self, m, it, ep):
            events.append(("it", it))

        def on_epoch_start(self, m):
            events.append(("start", m.epoch))

        def on_epoch_end(self, m):
            events.append(("end", m.epoch))

    net.set_listeners(Rec())
    pw = ParallelWrapper(net, collect_stats=True)
    pw.fit([DataSet(*_xy(6, seed=s)) for s in range(3)], num_epochs=2)
    assert [e for e in events if e[0] != "it"] == [("start", 0), ("end", 0),
                                                   ("start", 1), ("end", 1)]
    assert sum(e[0] == "it" for e in events) == 6
    d = pw.stats.as_dict()
    assert d["minibatches"] == 6 and d["examples"] == 36
    assert d["train_dispatch"]["count"] == 6 and d["epoch_sync"]["count"] == 2
    assert "train_dispatch" in pw.stats.to_string()
    st = TrainingStats()
    st.set_counter("c", 3)
    st.inc_counter("c")
    assert st.counters == {"c": 4}

    # early stopping through the wrapper is the single-process trainer's
    from deeplearning4j_tpu_torch.earlystopping import EarlyStoppingTrainer
    train = [DataSet(*_xy(8, seed=s)) for s in range(2)]
    val = [DataSet(*_xy(8, seed=9))]
    results = []
    for cls in (EarlyStoppingParallelTrainer, EarlyStoppingTrainer):
        m = _to_port(_jax_mln(), tmp_path, f"{cls.__name__}.zip")
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(3)])
        results.append(cls(cfg, m, train, val).fit())
    assert results[0].score_vs_epoch == results[1].score_vs_epoch
    assert results[0].total_epochs == 3


def test_watchdog_call_guard_sync():
    from deeplearning4j_tpu_torch.obs import flight
    wd = CollectiveWatchdog(timeout_s=5.0)
    assert wd.call(lambda: 41 + 1) == 42
    with pytest.raises(KeyError):
        wd.call(lambda: {}["x"])  # the callable's own error surfaces
    t = torch.ones(3)
    assert wd.sync([t]) == [t]
    fired = []
    release = threading.Event()
    flushed = []
    orig = flight.flush_flight_recorder
    flight.flush_flight_recorder = lambda reason: flushed.append(reason)
    try:
        quick = CollectiveWatchdog(timeout_s=0.2, on_timeout=fired.append)
        t0 = time.monotonic()
        with pytest.raises(CollectiveTimeoutError, match="did not complete within"):
            quick.call(release.wait, what="hung all-reduce")
        assert time.monotonic() - t0 < 3.0
        assert "process 0/1" in fired[0] and "hung all-reduce" in flushed[0]
        with pytest.raises(CollectiveTimeoutError):
            with quick.guard("slow section"):
                time.sleep(0.4)
        with quick.guard("fast section"):
            pass
    finally:
        release.set()
        flight.flush_flight_recorder = orig


def test_cli_trains_a_jax_written_zip(tmp_path):
    from deeplearning4j_tpu.parallel.__main__ import main as jmain
    from deeplearning4j_tpu.utils import serialization as jser
    from deeplearning4j_tpu_torch.parallel.__main__ import main as pmain
    src = tmp_path / "m.zip"
    jser.write_model(_jax_mln(), str(src))
    # 144 rows: batches of 48 divide the JAX package's 8 devices, no tail
    x, y = _xy(144, seed=3)
    csv = tmp_path / "d.csv"
    np.savetxt(csv, np.concatenate([x, y.argmax(1)[:, None]], 1), delimiter=",",
               fmt="%.6f")
    spec = f"csv:{csv}:4:3"
    jout, pout = tmp_path / "j.zip", tmp_path / "p.zip"
    jmain(["--model-path", str(src), "--data", spec, "--batch", "48", "--epochs", "2",
           "--model-output-path", str(jout)])
    pmain(["--model-path", str(src), "--data", spec, "--batch", "48", "--epochs", "2",
           "--model-output-path", str(pout), "--device", "cpu", "--report-stats"])
    a = pser.restore(str(pout), device="cpu")
    b = jser.restore(str(jout))
    assert a.iteration == b.iteration and a.epoch == b.epoch == 2
    for u, v in zip(_sorted_leaves(a.params), _jleaves(b.params)):
        np.testing.assert_allclose(u, v, rtol=0, atol=1e-5)
    # --tp trains tensor-parallel now; one process has one rank, not the two
    # a (dp, 2) mesh needs
    with pytest.raises(ValueError, match="tp=2"):
        pmain(["--model-path", str(src), "--data", "iris", "--tp", "2", "--device", "cpu"])


def test_named_refusals(tmp_path):
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    from deeplearning4j_tpu_torch.perf.prefetch import DevicePrefetchIterator
    net = _to_port(_jax_mln(), tmp_path)
    # tensor parallelism refuses by name the per-layer rules that read whole
    # leaves (a rank holds slices)
    clipped = _to_port(_jax_mln(), tmp_path, "clipped.zip")
    clipped._layer_confs = (dataclasses.replace(
        clipped._layer_confs[0], gradient_normalization="clip_l2_per_layer"),
        *clipped._layer_confs[1:])
    with pytest.raises(NotImplementedError, match="gradient_normalization"):
        ParallelWrapper(clipped, tensor_parallel=True).fit(DataSet(*_xy(4)))
    two = pmesh.Mesh(np.arange(2).reshape(2, 1), torch.device("cpu"))
    with pytest.raises(pmesh.MultiRankMeshError):
        ParallelInference(net, mesh=two, device="cpu")
    with pytest.raises(pmesh.MultiRankMeshError):
        DevicePrefetchIterator([], mesh=two)
    one = pmesh.make_mesh(device="cpu")
    pi = ParallelInference(net, mesh=one, inference_mode="sequential")
    x = _xy(4)[0]
    np.testing.assert_array_equal(np.asarray(pi.output(x)), net.output(x).numpy())
    assert DevicePrefetchIterator([], mesh=one).device == torch.device("cpu")
    # the bn kernels never take the plain path at a data world above 1: a
    # tensor that is not on the CPU goes to the split launches, and one
    # that is not on a card either raises before any launch
    z = torch.empty((8, 4), device="meta")
    g = torch.empty((4,), device="meta")
    with data_parallel.data_group(None, size=2):
        with pytest.raises(ValueError, match="cuda or cpu"):
            bn_act.bn_act_fwd("relu", 1e-5, z, g, g)
        with pytest.raises(ValueError, match="cuda or cpu"):
            bn_act.bn_act_bwd("relu", 1e-5, z, g, g, None, g, g, z)
    assert data_parallel.world() == 1
