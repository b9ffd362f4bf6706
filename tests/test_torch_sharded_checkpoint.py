"""Sharded checkpoints across the two packages, on the CPU.

- A network's shard zips (``simulated_shard_snapshots`` over 4 hosts,
  ``shard_zip_bytes``) written by each package hold the same members,
  metadata, block index (leaf keys, global shapes, dtypes, row ranges, in
  the same order) and bitwise-equal blocks; only the random-stream member
  differs by design (the JAX package's threefry key, the port's generator
  state).
- A 4-shard set either package writes restores in the other, reassembled
  into one model (4 → 1): parameters, layer state, updater state and
  counters bitwise, and ``state_sha`` equal in both packages.
- ``scan_shard_sets`` ignores an incomplete set, ``restore_blocks`` fetches
  only the shards holding the blocks asked for, and
  ``CheckpointManager(sharded=True)`` resumes a crashed fit bitwise.

Networks are built by the JAX package (a MultiLayerNetwork with batch norm
and a graph, Adam) and cross to the port as a model zip; data comes from
numpy with fixed seeds. Every comparison is exact.
"""

import hashlib
import io
import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.checkpoint import sharded as jshd
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.graph import GraphBuilder as JaxGraphBuilder
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JaxMergeVertex
from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.utils import serialization as jser

from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager, FaultInjector,
                                                 ObjectStoreBackend, SimulatedCrash)
from deeplearning4j_tpu_torch.checkpoint import sharded as pshd
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.utils import serialization as pser


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _jax_net(kind):
    upd = jupd.Adam(learning_rate=1e-2)
    if kind == "multilayer":
        conf = (JaxNNC.builder().seed(3).updater(upd).weight_init("xavier").list()
                .layer(jl.DenseLayer(n_out=6, activation="tanh"))
                .layer(JaxBN())
                .layer(jl.OutputLayer(n_out=3, loss="mcxent"))
                .set_input_type(JaxInputType.feed_forward(4)).build())
        net = JaxNet(conf).init()
    else:
        parent = JaxNNC.builder().seed(3).updater(upd).weight_init("xavier")
        conf = (JaxGraphBuilder(parent).add_inputs("in")
                .add_layer("d1", jl.DenseLayer(n_out=5, activation="relu"), "in")
                .add_layer("d2", jl.DenseLayer(n_out=5, activation="tanh"), "in")
                .add_vertex("merge", JaxMergeVertex(), "d1", "d2")
                .add_layer("out", jl.OutputLayer(n_out=3, activation="softmax",
                                                 loss="mcxent"), "merge")
                .set_outputs("out").set_input_types(JaxInputType.feed_forward(4)).build())
        net = JaxGraph(conf).init()
    net.fit(JaxDataSet(*_batch(0)))
    return net


@pytest.fixture(scope="module", params=["multilayer", "graph"])
def pair(request, tmp_path_factory):
    """A JAX network one Adam step in, and the port's copy of it (through
    the model zip, so parameters, running stats, updater state and counters
    are the JAX network's exactly)."""
    jnet = _jax_net(request.param)
    path = tmp_path_factory.mktemp("zip") / "net.zip"
    jser.write_model(jnet, str(path))
    return jnet, pser.restore(str(path), device="cpu")


def _shard_members(data: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = set(z.namelist())
        return {"names": names,
                "meta": json.loads(z.read("metadata.json")),
                "conf": json.loads(z.read("configuration.json")),
                "index": json.loads(z.read("blockindex.json")),
                "blocks": dict(np.load(io.BytesIO(z.read("blocks.npz"))))}


RANDOM_STREAM = {"has_rng", "has_torch_generator", "torch_generator_device"}


def test_shard_zips_member_for_member(pair):
    jnet, pnet = pair
    jsnaps = jshd.simulated_shard_snapshots(jnet, 4)
    psnaps = pshd.simulated_shard_snapshots(pnet, 4)
    assert len(jsnaps) == len(psnaps) == 4
    extra = {"seq": 2, "batch_in_epoch": 1}
    for js, ps in zip(jsnaps, psnaps):
        j = _shard_members(jshd.shard_zip_bytes(js, extra))
        p = _shard_members(pshd.shard_zip_bytes(ps, extra))
        common = {"metadata.json", "configuration.json", "blockindex.json", "blocks.npz"}
        assert common <= j["names"] and common <= p["names"]
        # the random stream is the only member that differs
        assert j["names"] - common <= {"rngState.npz"}
        assert p["names"] - common <= {pser.GENERATOR_MEMBER}
        assert ({k: v for k, v in j["meta"].items() if k not in RANDOM_STREAM}
                == {k: v for k, v in p["meta"].items() if k not in RANDOM_STREAM})
        assert j["conf"] == p["conf"]
        assert j["index"] == p["index"]
        assert j["blocks"].keys() == p["blocks"].keys()
        for k, a in j["blocks"].items():
            b = p["blocks"][k]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_state_sha_equal_across_packages(pair):
    jnet, pnet = pair
    assert pshd.state_sha(pnet) == jshd.state_sha(jnet)


def _port_state(net) -> dict:
    snap = pser.snapshot_training_state(net)
    out = {f"c:{k}": v for k, v in snap["coefficients"].items()}
    out.update({f"u:{k}": np.asarray(v) for k, v in snap["updater_state"].items()})
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_four_shard_set_restores_across_packages_four_to_one(pair, writer):
    """A 4-host set written by ``writer`` reassembles in the other package
    (and in its own) into the network it was cut from, bitwise."""
    jnet, pnet = pair
    shd, net = (jshd, jnet) if writer == "jax" else (pshd, pnet)
    payloads = [shd.shard_zip_bytes(s, {"batch_in_epoch": 0})
                for s in shd.simulated_shard_snapshots(net, 4)]
    want = jshd.state_sha(jnet)
    pm, pmeta = pshd.restore_from_payloads(payloads, device="cpu")
    jm, jmeta = jshd.restore_from_payloads(payloads)
    assert pmeta["num_hosts"] == jmeta["num_hosts"] == 4
    assert pshd.state_sha(pm) == jshd.state_sha(jm) == want
    assert (pm.iteration, pm.epoch) == (jm.iteration, jm.epoch) == (jnet.iteration, jnet.epoch)
    got, ref = _port_state(pm), _port_state(pnet)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].tobytes() == ref[k].tobytes(), k
    # the reassembled network takes the step a copy restored from the
    # whole-zip checkpoint takes, bitwise
    x, y = _batch(1)
    pm.fit(DataSet(x, y))
    twin = pser.restore_checkpoint(io.BytesIO(pser.checkpoint_zip_bytes(
        pser.snapshot_training_state(pnet))), device="cpu")[0]
    twin.fit(DataSet(x, y))
    assert pshd.state_sha(pm) == pshd.state_sha(twin)


def test_incomplete_set_ignored_and_restore_blocks(tmp_path):
    """A set missing a shard is skipped by ``scan_shard_sets`` and by the
    manager's manifest rebuild; ``restore_blocks`` fetches only the shards
    holding the blocks asked for."""
    bucket = {}
    net = _port_net()
    cm = CheckpointManager(storage=ObjectStoreBackend(bucket), sharded=True, device="cpu")
    x, y = _batch(2, 24)
    net.fit(DataSet(x, y))
    first = cm.save(net)
    assert first.endswith(".sharded")
    (entry,) = cm.checkpoints()
    assert entry["sharded"] and entry["num_hosts"] == 1
    assert all(s["sha256"] and s["blocks"] for s in entry["shards"])
    w = net.params[0]["W"].detach().numpy()
    blocks = cm.restore_blocks(lambda tree, leaf, index: leaf == "0/0/W",
                               trees=("coefficients",))
    ((index, arr),) = blocks["coefficients"]["0/0/W"]
    assert index == ((0, w.shape[0]), (0, w.shape[1])) and arr.tobytes() == w.tobytes()
    # a 4-host set under a second journal entry: selection reads one shard
    base = "ckpt-0000000002-00002"
    shards = []
    for snap in pshd.simulated_shard_snapshots(net, 4):
        data = pshd.shard_zip_bytes(snap, {"seq": 2, "batch_in_epoch": 0})
        name = pshd.shard_object_name(base, snap["host"], 4)
        bucket[name] = data
        shards.append({"file": name, "size": len(data),
                       "sha256": hashlib.sha256(data).hexdigest(),
                       "blocks": pshd.shard_block_summary(data)})
    entry4 = dict(entry, file=f"{base}.sharded", num_hosts=4, shards=shards, seq=2)
    reads = []
    store = ObjectStoreBackend(bucket)
    store.get = (lambda get: lambda name: reads.append(name) or get(name))(store.get)
    got = pshd.fetch_blocks(store, entry4,
                            lambda tree, leaf, index: leaf == "0/0/W" and index[0][0] == 0,
                            trees=("coefficients",))
    assert reads == [shards[0]["file"]]
    for index, arr in got["coefficients"]["0/0/W"]:
        assert arr.tobytes() == w[slice(*index[0])].tobytes()
    assert [e["file"] for e in pshd.scan_shard_sets(ObjectStoreBackend(bucket))] == [
        first, entry4["file"]]
    del bucket[shards[1]["file"]]
    del bucket["manifest.json"]
    assert [e["file"] for e in pshd.scan_shard_sets(ObjectStoreBackend(bucket))] == [first]
    cm2 = CheckpointManager(storage=ObjectStoreBackend(bucket), device="cpu")
    assert [e["file"] for e in cm2.checkpoints()] == [first]
    assert pshd.state_sha(cm2.restore_latest()) == pshd.state_sha(net)


def _port_net(seed=7):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Adam(0.01)).weight_init("xavier").list()
            .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.8))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_sharded_manager_crash_exact_resume(tmp_path):
    """fit with a sharded manager (a set every 3 steps) killed at step 7,
    restored at step 6 and resumed: parameters, updater state, counters
    and the dropout generator bitwise the uninterrupted run's; retention
    deletes whole sets; the JAX package reads the port's set."""
    x, y = _batch(4, 160)
    batches = DataSet(x, y).split(32)
    ref = _port_net()
    ref.fit(batches, num_epochs=2)
    bucket = {}
    cm = CheckpointManager(storage=ObjectStoreBackend(bucket), sharded=True,
                           save_every_n_steps=3, keep_last=2, device="cpu")
    net = _port_net().set_listeners(FaultInjector(kill_at_step=7))
    with pytest.raises(SimulatedCrash):
        net.fit(batches, num_epochs=2, checkpoint_manager=cm)
    assert [e["step"] for e in cm.checkpoints()] == [3, 6]
    cm2 = CheckpointManager(storage=ObjectStoreBackend(bucket), sharded=True,
                            save_every_n_steps=3, keep_last=2, device="cpu")
    resumed = cm2.restore_latest()
    rs = resumed._resume_state
    assert (rs.step, rs.epoch, rs.batch_in_epoch) == (6, 1, 1)
    resumed.fit(batches, num_epochs=2, checkpoint_manager=cm2)
    assert pshd.state_sha(resumed) == pshd.state_sha(ref)
    assert torch.equal(resumed._gen.get_state(), ref._gen.get_state())
    assert (resumed.iteration, resumed.epoch) == (ref.iteration, ref.epoch) == (10, 2)
    assert [e["step"] for e in cm2.checkpoints()] == [6, 9]
    kept = {s["file"] for e in cm2.checkpoints() for s in e["shards"]}
    assert {k for k in bucket if k.startswith(pshd.SHARD_PREFIX)} == kept
    newest = cm2.checkpoints()[-1]
    payloads = [bucket[s["file"]] for s in newest["shards"]]
    jm, _ = jshd.restore_from_payloads(payloads)
    assert jm.iteration == 9
    assert jshd.state_sha(jm) == pshd.state_sha(cm2.restore_latest())
