"""The PyTorch port's checkpoint tier on the CPU: the counterparts of the
JAX package's ``tests/test_checkpoint.py`` (crash -> ``restore_latest`` ->
resume bitwise on both networks; torn, bit-flipped and corrupt files and a
torn or missing manifest fall back; counters and the dropout generator
exact; retention; both triggers; async flush and error surfacing; the
context manager), plus ``train_until`` over a ``FlakyBackend`` and the
refusals of what is not ported (multi-process saves, zips and shard sets
carrying modules the port lacks).

Networks are built with the port's builders from seeds; data comes from
numpy with fixed seeds. The MultiLayerNetwork carries dropout, so a resume
that lost the generator's state would not be bitwise. Every comparison
here is exact: a resume replays the same float operations in the same
order. No test sleeps: retries and restarts get a zero backoff.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.checkpoint import (CheckpointError, CheckpointManager,
                                                 FaultInjector, FlakyBackend,
                                                 ManifestError, ObjectStoreBackend,
                                                 RestartPolicy, RetryingBackend,
                                                 SimulatedCrash, flip_byte,
                                                 flip_object_byte, load_manifest,
                                                 tear_file, tear_object, train_until)
from deeplearning4j_tpu_torch.checkpoint.manager import skip_consumed_batches
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Sgd


def _net(seed=7):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Sgd(learning_rate=0.05)).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.8))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _graph(seed=5):
    conf = (GraphBuilder()
            .add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=12, activation="relu"), "in")
            .add_layer("d2", DenseLayer(n_out=12, activation="tanh"), "in")
            .add_vertex("merge", MergeVertex(), "d1", "d2")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                          updater=Adam(0.02)), "merge")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4))
            .build())
    return ComputationGraph(conf, device="cpu").init()


NETS = {"multilayer": _net, "graph": _graph}


def _batches(n=160, batch=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 4), np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(x, y).split(batch)


def _cm(path, **kw):
    return CheckpointManager(path, device="cpu", **kw)


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _assert_same_run(ref, got):
    _assert_bitwise(ref.params, got.params)
    _assert_bitwise(ref.state, got.state)
    _assert_bitwise(ref.opt_state, got.opt_state)
    assert (ref.iteration, ref.epoch) == (got.iteration, got.epoch)
    assert torch.equal(ref._gen.get_state(), got._gen.get_state())


# ------------------------------------------------- crash → resume ≡ bitwise
@pytest.mark.parametrize("kind,n,batch,epochs,every,kill,restored", [
    # 5 batches x 2 epochs, checkpoints at 3 and 6: step 6 is batch 1 of epoch 1
    ("multilayer", 160, 32, 2, 3, 7, (6, 1, 1)),
    # 2 batches x 3 epochs; the step-4 crash fires before step 4's save, and
    # step 2's save came at the end of epoch 0, before its epoch boundary
    ("graph", 128, 64, 3, 2, 4, (2, 0, 2)),
])
def test_crash_resume_bitwise(tmp_path, kind, n, batch, epochs, every, kill, restored):
    """Kill mid-run, restore the newest checkpoint in a fresh manager,
    resume: parameters, state, updater state, counters and the dropout
    generator end bitwise-equal to the uninterrupted run."""
    batches = _batches(n, batch)
    ref = NETS[kind]()
    ref.fit(batches, num_epochs=epochs)

    cm = _cm(tmp_path / "ck", save_every_n_steps=every)
    crashed = NETS[kind]().set_listeners(FaultInjector(kill_at_step=kill))
    with pytest.raises(SimulatedCrash):
        crashed.fit(batches, num_epochs=epochs, checkpoint_manager=cm)
    cm.close()

    cm2 = _cm(tmp_path / "ck")
    resumed = cm2.restore_latest()
    rs = resumed._resume_state
    assert (rs.step, rs.epoch, rs.batch_in_epoch) == restored
    resumed.fit(batches, num_epochs=epochs, checkpoint_manager=cm2)
    cm2.close()
    assert resumed._resume_state is None  # consumed
    _assert_same_run(ref, resumed)


def test_resume_controls_miss(tmp_path):
    """The resume's two ingredients each matter: without the updater state,
    or without skipping the consumed batches, the run ends elsewhere."""
    batches = _batches()
    ref = _graph()
    ref.fit(batches, num_epochs=2)
    cm = _cm(tmp_path / "ck", save_every_n_steps=3)
    crashed = _graph().set_listeners(FaultInjector(kill_at_step=7))
    with pytest.raises(SimulatedCrash):
        crashed.fit(batches, num_epochs=2, checkpoint_manager=cm)
    cm.close()
    cm2 = _cm(tmp_path / "ck")
    no_updater = cm2.restore_latest(load_updater=False)
    no_updater.fit(batches, num_epochs=2)
    no_skip = cm2.restore_latest()
    no_skip._resume_state.batch_in_epoch = 0
    no_skip.fit(batches, num_epochs=2)
    for net in (no_updater, no_skip):
        assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(ref.params),
                                                         tree_leaves(net.params)))


# --------------------------------------------------- durability / fallback
def _two_saves(d, metrics=(None, None), **kw):
    cm = _cm(d, async_write=False, **kw)
    net = _net()
    batches = _batches(96, 32)
    names = []
    for ds, m in zip(batches, metrics):
        net.fit(ds)
        names.append(cm.save(net, metric=m))
    return cm, net, names


@pytest.mark.parametrize("corrupt", ["torn", "bitflip"])
def test_corrupt_newest_checkpoint_falls_back(tmp_path, corrupt):
    """A truncated (torn-write) or bit-flipped newest checkpoint must not
    restore: the journal's sha256 catches it and the previous checkpoint
    comes back instead."""
    d = str(tmp_path / "ck")
    cm, _, names = _two_saves(d)
    path = os.path.join(d, names[-1])
    tear_file(path) if corrupt == "torn" else flip_byte(path, offset=200)
    assert cm.restore_latest()._resume_state.step == 1
    cm.close()


@pytest.mark.parametrize("manifest", ["torn", "missing"])
def test_lost_manifest_rebuilds_full_entries(tmp_path, manifest):
    """A torn or deleted manifest is rebuilt from the surviving zips with
    their metadata (step, metric), so restore_best and checkpoints() keep
    working; with the torn manifest the newest zip is torn too, and the zip
    CRC layer skips it."""
    d = str(tmp_path / "ck")
    cm, _, names = _two_saves(d, metrics=(3.0, 1.0))
    cm.close()
    if manifest == "torn":
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write("{torn")
        with pytest.raises(ManifestError):
            load_manifest(d)
        tear_file(os.path.join(d, names[-1]))
        want = [(1, 3.0)]
    else:
        os.remove(os.path.join(d, "manifest.json"))
        want = [(1, 3.0), (2, 1.0)]
    cm2 = _cm(d)
    assert load_manifest(d) is not None
    entries = cm2.checkpoints()
    assert [(e["step"], e["metric"]) for e in entries] == want
    assert all("size" in e and e["sha256"] for e in entries)
    assert cm2.restore_latest()._resume_state.step == want[-1][0]
    assert cm2.restore_best()._restored_from.step == min(want, key=lambda e: e[1])[0]
    cm2.close()


def test_restore_latest_empty_dir_returns_none(tmp_path):
    cm = _cm(tmp_path / "empty")
    assert cm.restore_latest() is None
    assert cm.restore_best() is None
    cm.close()


def test_checkpoint_restores_generator_and_counters_exactly(tmp_path):
    """The restored network carries the dropout generator's state, the
    iteration and epoch, parameters and updater state, exactly; and its
    next step draws what the original's next step draws."""
    cm = _cm(tmp_path / "ck", async_write=False)
    net = _net()
    net.fit(_batches(64, 32), num_epochs=2)
    cm.save(net)
    restored = cm.restore_latest()
    cm.close()
    _assert_same_run(net, restored)
    ds = _batches(32, 32, seed=3)[0]
    net.fit(ds)
    restored._resume_state = None
    restored.fit(ds)
    _assert_bitwise(net.params, restored.params)


# ---------------------------------------------------------------- retention
def test_retention_keep_last_prunes_and_keep_best_pins(tmp_path):
    d = str(tmp_path / "ck")
    cm = _cm(d, keep_last=2, keep_best="min", async_write=False)
    net = _net()
    for ds, metric in zip(_batches(160, 32), [5.0, 1.0, 4.0, 3.0, 2.0]):
        net.fit(ds)
        cm.save(net, metric=metric)
    entries = cm.checkpoints()
    # best (metric 1.0, step 2) pinned + the last two (steps 4, 5)
    assert [(e["step"], e["metric"]) for e in entries] == [(2, 1.0), (4, 3.0), (5, 2.0)]
    assert len([f for f in os.listdir(d) if f.endswith(".zip")]) == 3
    best = cm.restore_best()
    assert best._restored_from.step == 2
    assert best._resume_state is None  # model selection does not arm a resume
    assert cm.restore_latest()._resume_state.step == 5
    cm.close()


def test_saver_usage_defaults_keep_best_so_retention_cannot_prune_it(tmp_path):
    cm = _cm(tmp_path / "ck", keep_last=2, async_write=False)
    net = _net()
    for ds, score in zip(_batches(160, 32), [5.0, 1.0, 4.0, 3.0, 2.0]):
        net.fit(ds)
        cm.save_best_model(net, score)
    assert cm.keep_best == "min"
    assert cm.get_best_model()._restored_from.step == 2
    cm.close()


# ----------------------------------------------------------------- triggers
def test_save_every_secs_trigger(tmp_path):
    """save_every_secs=0 degenerates to every step — the time trigger path."""
    cm = _cm(tmp_path / "ck", save_every_secs=0.0, async_write=False)
    _net().fit(_batches(96, 32), checkpoint_manager=cm)
    # one per step_end (3) + the epoch_end boundary save
    assert len(cm.checkpoints()) == 4
    assert cm.checkpoints()[-1]["batch_in_epoch"] == 0
    cm.close()


def test_step_trigger_is_threshold_not_modulo(tmp_path):
    """tbptt batches advance iteration by several windows a step_end; the
    trigger is '>= n steps since the last save', not an exact modulo."""
    cm = _cm(tmp_path / "ck", save_every_n_steps=10, async_write=False)
    net = _net()
    net.fit(_batches(32, 32))
    for it in (7, 14, 21, 28):
        net.iteration = it
        cm.step_end(net, batch_in_epoch=1)
    assert [e["step"] for e in cm.checkpoints()] == [14, 28]
    cm.close()


def test_resume_skip_raises_on_short_stream():
    assert list(skip_consumed_batches([1, 2, 3], 2)) == [3]
    with pytest.raises(ValueError, match="ended after 2"):
        skip_consumed_batches([1, 2], 3)


# -------------------------------------------------------------- async path
def test_async_flush_commits_everything_and_matches_live(tmp_path):
    cm = _cm(tmp_path / "ck", save_every_n_steps=1)
    net = _net()
    net.fit(_batches(96, 32), checkpoint_manager=cm)
    cm.flush()
    assert len(cm.checkpoints()) == 3
    assert cm.saves_committed == cm.saves_requested == 3
    assert len(cm.timings["snapshot_ms"]) == len(cm.timings["commit_ms"]) == 3
    restored = cm.restore_latest()
    cm.close()
    # the last save came at step 3, before the epoch boundary
    assert (restored.iteration, restored.epoch) == (3, 0)
    restored.epoch = net.epoch
    _assert_same_run(net, restored)


def test_async_write_error_surfaces_on_training_thread(tmp_path):
    """A failing writer raises CheckpointError at the next flush, on the
    training thread. (A file squats where the directory was.)"""
    d = str(tmp_path / "ck")
    cm = _cm(d, save_every_n_steps=1)
    net = _net()
    net.fit(_batches(32, 32), checkpoint_manager=cm)
    cm.flush()
    shutil.rmtree(d)
    open(d, "w").close()
    net.fit(_batches(32, 32), checkpoint_manager=cm)
    with pytest.raises(CheckpointError):
        cm.flush()
    cm.close()


def test_async_writer_keeps_every_save_under_thread_switch_stress():
    """Saves queued faster than a one-deep queue drains, with the
    interpreter switching threads every microsecond: every save commits,
    the journal stays in save order, and the newest restores bitwise."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cm = CheckpointManager(storage=ObjectStoreBackend(), queue_depth=1, device="cpu")
        net = _net()
        ds = _batches(32, 32)[0]
        for _ in range(12):
            net.fit(ds)
            cm.save(net)
        cm.flush()
        cm.close()
    finally:
        sys.setswitchinterval(switch)
    assert cm.saves_committed == cm.saves_requested == 12
    assert [e["seq"] for e in cm.checkpoints()] == list(range(1, 13))
    restored = cm.restore_latest()
    restored.epoch = net.epoch
    _assert_same_run(net, restored)


def test_context_manager_and_double_close(tmp_path):
    with _cm(tmp_path / "ck", save_every_n_steps=1) as cm:
        _net().fit(_batches(64, 32), checkpoint_manager=cm)
    cm.close()  # idempotent
    assert len(cm.checkpoints()) == 2


# ------------------------------------------------------ restarts and chaos
def test_train_until_over_flaky_backend_is_bitwise():
    """train_until over RetryingBackend(FlakyBackend(object store)): seeded
    transient storage faults and two kills (one mid-epoch, one at an epoch
    boundary) end bitwise-equal to the uninterrupted run."""
    batches = _batches()
    ref = _net()
    ref.fit(batches, num_epochs=3)
    flaky = FlakyBackend(ObjectStoreBackend(), seed=3, transient_rate=0.2)
    storage = RetryingBackend(flaky, max_retries=8, sleep=lambda s: None)
    cm = CheckpointManager(storage=storage, save_every_n_steps=2, async_write=False,
                           device="cpu")
    injectors = [FaultInjector(kill_at_step=6), FaultInjector(kill_at_epoch=2)]
    net = _net().set_listeners(injectors[0])

    def rearm(model, attempt):
        if attempt < len(injectors):
            model.set_listeners(injectors[attempt])

    summary = train_until(net, batches, num_epochs=3, checkpoint_manager=cm,
                          restart_policy=RestartPolicy(max_restarts=4, backoff_s=0.0),
                          on_restart=rearm)
    assert summary.completed and summary.restarts == 2
    assert [c.error_type for c in summary.crashes] == ["SimulatedCrash"] * 2
    assert flaky.faults_injected > 0 and storage.retries > 0
    _assert_same_run(ref, summary.model)


@pytest.mark.parametrize("how", ["object_torn", "object_bitflip"])
def test_object_store_corruption_falls_back(how):
    store = ObjectStoreBackend()
    cm = CheckpointManager(storage=store, async_write=False, device="cpu")
    net = _net()
    names = []
    for ds in _batches(64, 32):
        net.fit(ds)
        names.append(cm.save(net))
    (tear_object if how == "object_torn" else flip_object_byte)(store, names[-1])
    assert cm.restore_latest()._resume_state.step == 1


def test_process_kill_mode_sigkills_the_process():
    code = ("from deeplearning4j_tpu_torch.checkpoint.faults import FaultInjector\n"
            "FaultInjector(kill_at_step=1, kill_mode='process').iteration_done(None, 0, 0)\n"
            "print('survived')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == -9 and "survived" not in out.stdout


# ---------------------------------------------------------------- refusals
def test_unported_checkpoint_paths_are_refused(tmp_path):
    """Zips and shard sets carrying the modules the port once lacked now
    restore them (sharded=True: checkpoint/sharded.py). A TuningRecord
    (perf/autotune.py) rides a shard set and a checkpoint zip, and
    restore_latest returns the newest zip with it. Gradient compression
    (parallel/compress.py): a shard set carrying it restores with its
    scheme and state."""
    from deeplearning4j_tpu_torch.checkpoint import sharded as shd
    from deeplearning4j_tpu_torch.parallel import Int8Compression, enable_grad_compression
    from deeplearning4j_tpu_torch.perf.autotune import TuningRecord, conf_signature
    net0 = _net()
    sig = conf_signature(net0.conf)
    rec = TuningRecord(model_type="MultiLayerConfiguration", dtype="float32", signature=sig,
                       tuned_signature=sig, batch_size=8, fusion=False, donate=True,
                       remat={}, buckets=(8,), objective={}, baseline={},
                       candidates_searched=1)
    # a TuningRecord is ported (perf/autotune.py): it rides a shard set
    snap = shd.shard_snapshot(net0)
    back, _ = shd.restore_from_payloads(
        [shd.shard_zip_bytes(snap, {"tuning_record": rec.to_dict()})], device="cpu")
    assert back._tuning_record == rec
    comp = _net()
    enable_grad_compression(comp, Int8Compression())
    comp.fit(_batches(32, batch=8, seed=1)[0])
    back, meta = shd.restore_from_payloads([shd.shard_zip_bytes(shd.shard_snapshot(comp))],
                                           device="cpu")
    assert meta["has_compress"] and back.grad_compression == Int8Compression()
    assert shd.state_sha(back) == shd.state_sha(comp)
    d = str(tmp_path / "ck")
    cm, net, names = _two_saves(d)
    path = os.path.join(d, names[-1])
    buf = io.BytesIO()
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(buf, "w") as dst:
        for item in src.namelist():
            dst.writestr(item, src.read(item))
        dst.writestr("tuning.json", rec.to_json())
    data = buf.getvalue()
    cm._storage.put(names[-1], data)
    with cm._lock:  # journal the new bytes, so the newest zip is the one restored
        import hashlib
        cm._entries[-1]["sha256"] = hashlib.sha256(data).hexdigest()
    assert cm.restore_latest()._tuning_record == rec
    cm.close()
