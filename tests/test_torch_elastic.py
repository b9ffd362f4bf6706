"""The elastic tier of the PyTorch port on the CPU (the counterparts of
``tests/test_elastic.py``'s lease, rendezvous, fencing and world-of-one
worker tests).

- Leases follow the observer's clock; the initial quorum forms with the
  smallest id leading; bumps, deaths and arrivals end a generation; a dead
  worker is excluded after one TTL; an evicted worker rejoins at a later
  generation; a stuck peer bounds the join by its deadline. In-memory
  store, threads, injected clocks.
- A lease and a membership record are the JAX package's JSON byte for
  byte, and each package's rendezvous reads the other's records.
- The generation fence refuses a stale leader's checkpoint commit.
- ``ElasticWorker`` at world 1: epoch checkpoints, a bump after the first
  epoch taking the run across a generation boundary with the final
  ``state_sha`` equal to an uninterrupted ``ClusterTrainer`` run's, and a
  hung collective escalating to a membership bump.
- (``slow``) a 2-process gloo fleet in which one worker is SIGKILLed: the
  survivor's watchdog escalates, it re-forms a world of one and finishes.

JAX is imported inside the tests, not at module top.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, ObjectStoreBackend
from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel import (ClusterTrainer, CollectiveTimeoutError,
                                               ElasticWorker, LeaseBoard, Membership,
                                               Rendezvous, RendezvousTimeout,
                                               StaleGenerationError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(seed=7):
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(0.01))
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.9))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _batches(n=96, batch=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 4), np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(x, y).split(batch)


def _board(store, wid, ttl=0.4, clock=time.time):
    return LeaseBoard(store, wid, ttl_s=ttl, heartbeat_s=0.1, clock=clock)


def _rdzv(store, board, **kw):
    kw.setdefault("join_timeout_s", 15.0)
    kw.setdefault("poll_s", 0.02)
    return Rendezvous(store, board, **kw)


def _threads(fns):
    ts = [threading.Thread(target=f) for f in fns]
    [t.start() for t in ts]
    [t.join(20) for t in ts]


# ==================================================== leases / rendezvous
def test_lease_liveness_and_records_equal_jax():
    from deeplearning4j_tpu.parallel import elastic as jel
    from deeplearning4j_tpu.parallel.leases import LeaseBoard as JLeaseBoard
    t = [1000.0]
    store = ObjectStoreBackend()
    b = _board(store, "a", ttl=5.0, clock=lambda: t[0])
    b.write(barrier=1)
    assert set(b.live()) == {"a"}
    t[0] += 5.1  # expired-but-alive: the OBSERVER's clock decides
    assert set(b.live()) == set()
    b.write()
    assert set(b.live()) == {"a"}
    # the same lease bytes as the JAX package's board, field for field
    from deeplearning4j_tpu.checkpoint import ObjectStoreBackend as JStore
    jb = JLeaseBoard(JStore(), "a", ttl_s=5.0, clock=lambda: t[0])
    jb.incarnation = b.incarnation
    jb.set_payload(addr="h:1")
    b.set_payload(addr="h:1")
    b.write(barrier=3)
    jb._seq = b._seq - 1
    jb.write(barrier=3)
    assert store.get("lease-a") == jb.store.get("lease-a")
    assert set(jb.live(b.read_all())) == {"a"}  # each reads the other's leases
    # membership records both ways
    m = Membership(generation=4, members=["a", "b"], coordinator="localhost:5",
                   reason="r", writer="a")
    jm = jel.Membership(generation=4, members=["a", "b"], coordinator="localhost:5",
                        reason="r", writer="a")
    assert m.to_json() == jm.to_json()
    assert jel.Membership.from_json(m.to_json()) == jm
    store.put("gen-000004", jm.to_json())
    assert _rdzv(store, b).current() == m


def test_initial_quorum_bump_death_and_arrival():
    store = ObjectStoreBackend()
    boards = {w: _board(store, w) for w in ("b", "a")}
    rds = {w: _rdzv(store, boards[w]) for w in boards}
    out = {}
    _threads([lambda w=w: out.__setitem__(w, rds[w].propose_or_await(1, expected=2))
              for w in rds])
    assert out["a"].members == out["b"].members == ["a", "b"]
    assert out["a"].generation == 1 and out["a"].rank_of("a") == 0
    assert out["a"].coordinator.count(":") == 1
    ra = rds["a"]
    assert ra.membership_changed(out["a"]) is None
    ra.request_bump(1, "test reason")
    assert "test reason" in ra.membership_changed(out["a"])
    store.put("gen-000002", Membership(generation=2, members=["a"],
                                       coordinator="localhost:2").to_json())
    assert "superseded" in ra.membership_changed(out["a"])
    # death and arrival, on an injected clock
    t = [50.0]
    store = ObjectStoreBackend()
    a = _board(store, "a", ttl=5.0, clock=lambda: t[0])
    b = _board(store, "b", ttl=5.0, clock=lambda: t[0])
    ra = _rdzv(store, a)
    m = Membership(generation=1, members=["a", "b"], coordinator="localhost:1")
    a.write(barrier=1)
    b.write(barrier=1)
    assert ra.membership_changed(m) is None
    t[0] += 6
    a.write()
    assert "expired" in ra.membership_changed(m)
    b.write()
    _board(store, "c", ttl=5.0, clock=lambda: t[0]).write(barrier=2)
    assert "waiting" in ra.membership_changed(m)


def test_dead_worker_excluded_and_evicted_worker_rejoins():
    store = ObjectStoreBackend()
    a, b = _board(store, "a", ttl=0.3), _board(store, "b", ttl=0.3)
    _board(store, "dead-c", ttl=0.3).write(barrier=1)  # held gen 1, then died
    out = {}
    _threads([lambda: out.__setitem__("a", _rdzv(store, a).propose_or_await(2)),
              lambda: out.__setitem__("b", _rdzv(store, b).propose_or_await(2))])
    assert out["a"].members == out["b"].members == ["a", "b"]
    # eviction: c's lease lapses while it is alive; it must rejoin later
    store = ObjectStoreBackend()
    boards = {w: _board(store, w, ttl=0.35) for w in ("a", "b", "c")}
    rds = {w: _rdzv(store, boards[w]) for w in boards}

    def join(w, gen, key, expected=None):
        out[key] = rds[w].propose_or_await(gen, expected=expected)
    _threads([lambda w=w: join(w, 1, f"{w}1", 3) for w in rds])
    assert out["a1"].members == ["a", "b", "c"]
    time.sleep(0.5)
    boards["a"].write()
    boards["b"].write()
    _threads([lambda w=w: join(w, 2, f"{w}2") for w in ("a", "b")])
    assert out["a2"].members == ["a", "b"]
    boards["a"].start()
    boards["b"].start()
    tc = threading.Thread(target=lambda: join("c", 2, "c3"))
    tc.start()
    deadline = time.monotonic() + 10
    while rds["a"].membership_changed(out["a2"]) is None and time.monotonic() < deadline:
        time.sleep(0.02)
    _threads([lambda w=w: join(w, 3, f"{w}3") for w in ("a", "b")])
    tc.join(20)
    boards["a"].stop()
    boards["b"].stop()
    assert rds["c"].evictions == 1
    assert out["c3"].generation == out["a3"].generation == 3
    assert out["c3"].members == ["a", "b", "c"]


def test_rendezvous_timeout_and_generation_fence():
    store = ObjectStoreBackend()
    b = _board(store, "a", ttl=60.0)
    _board(store, "stuck", ttl=60.0).write(barrier=0)
    with pytest.raises(RendezvousTimeout):
        _rdzv(store, b, join_timeout_s=0.5).propose_or_await(1)
    rdzv_store = ObjectStoreBackend()
    cm = CheckpointManager(storage=ObjectStoreBackend(), sharded=True, device="cpu")
    worker = ElasticWorker(store=rdzv_store, worker_id="a", checkpoint_manager=cm)
    m_old = Membership(generation=1, members=["a", "b"], coordinator="localhost:1")
    rdzv_store.put("gen-000001", m_old.to_json())
    net = _net()
    cm.commit_guard = lambda: worker._assert_current(m_old)
    assert cm.save(net) is not None
    n_entries = len(cm.checkpoints())
    rdzv_store.put("gen-000002", Membership(generation=2, members=["b"],
                                            coordinator="localhost:2").to_json())
    net.fit(_batches()[0])
    with pytest.raises(StaleGenerationError):
        cm.save(net)
    assert len(cm.checkpoints()) == n_entries


# ============================================== elastic worker, world of 1
class _Hook:
    """Listener: ``on_epoch_end`` / ``iteration_done`` run ``fn`` once."""

    def __init__(self, at, fn):
        self.at, self.fn, self.fired = at, fn, False

    def _maybe(self, where):
        if where == self.at and not self.fired:
            self.fired = True
            self.fn()

    def iteration_done(self, model, iteration, epoch):
        self._maybe("step")

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        self._maybe("epoch")


def _worker(on_generation=None, **kw):
    cm = CheckpointManager(storage=ObjectStoreBackend(), sharded=True, async_write=False,
                           device="cpu")
    return ElasticWorker(store=ObjectStoreBackend(), worker_id="w00", checkpoint_manager=cm,
                         num_workers=1, lease_ttl_s=1.0, poll_s=0.02, join_timeout_s=20.0,
                         on_generation=on_generation, **kw), cm


def test_world1_generation_boundary_is_bitwise_the_uninterrupted_run():
    data = _batches()
    ref = _net()
    ClusterTrainer(ref).fit(data, num_epochs=3)

    def on_generation(model, m, rank, world):
        if m.generation == 1:  # ask for a new generation after epoch 1
            model.add_listener(_Hook("epoch", lambda: worker.rendezvous.request_bump(
                1, "test: bump after epoch 1")))
    worker, cm = _worker(on_generation)
    summary = worker.run(_net, data, num_epochs=3)
    assert summary.completed and summary.model.epoch == 3
    assert [g.generation for g in summary.generations] == [1, 2]
    assert "bump requested" in summary.generations[0].ended
    assert summary.generations[0].epochs == 1 and summary.generations[1].epochs == 2
    assert summary.generations[1].restored_from is not None
    assert [e["step"] for e in cm.checkpoints()] == [0, 4, 8, 12]
    assert state_sha(summary.model) == state_sha(ref)


def test_collective_timeout_escalates_to_membership_bump():
    def on_generation(model, m, rank, world):
        if m.generation == 1:
            def hang():
                raise CollectiveTimeoutError("simulated hung collective")
            model.add_listener(_Hook("step", hang))
    worker, cm = _worker(on_generation)
    summary = worker.run(_net, _batches(), num_epochs=2)
    assert summary.completed and summary.model.epoch == 2
    assert len(summary.generations) == 2
    assert "membership bump" in summary.generations[0].ended
    assert worker.store.exists("bump-000001")
    assert summary.generations[1].restored_from is not None


# ======================================================= a fleet of two
def _fleet_worker(wid, store_dir, out_dir, epochs):
    from deeplearning4j_tpu_torch.checkpoint import LocalFSBackend
    from deeplearning4j_tpu_torch.checkpoint.supervisor import ELASTIC_RESTART_EXIT
    from deeplearning4j_tpu_torch.parallel import ElasticRestartRequired
    import torch
    torch.set_num_threads(1)
    cm = CheckpointManager(os.path.join(store_dir, "ck"), sharded=True, async_write=False,
                           device="cpu", barrier_timeout_s=10)

    def on_generation(model, m, rank, world):
        with open(os.path.join(out_dir, f"{wid}.gen{m.generation}"), "w") as f:
            f.write(f"{rank} {world}")
        model.add_listener(_Hook("step", lambda: time.sleep(0.05)))
    worker = ElasticWorker(store=LocalFSBackend(os.path.join(store_dir, "rdzv")),
                           worker_id=wid, checkpoint_manager=cm, num_workers=2,
                           lease_ttl_s=2.0, poll_s=0.05, join_timeout_s=60,
                           collective_timeout_s=4.0, init_timeout_s=30,
                           on_generation=on_generation)
    try:
        summary = worker.run(_net, _batches(n=192), num_epochs=epochs)
    except ElasticRestartRequired:
        os._exit(ELASTIC_RESTART_EXIT)
    with open(os.path.join(out_dir, f"{wid}.done"), "w") as f:
        json.dump({"epochs": summary.model.epoch,
                   "gens": [[g.generation, g.world_size] for g in summary.generations]}, f)
    os._exit(0)


@pytest.mark.slow
def test_two_worker_fleet_survives_a_sigkill(tmp_path):
    """w01 is SIGKILLed once generation 1 has trained a few steps; w00's
    watchdog or the boundary vote ends generation 1, and w00 finishes the
    run alone in a later generation of world 1."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    procs = {w: subprocess.Popen([sys.executable, os.path.abspath(__file__), w,
                                  str(tmp_path), str(tmp_path), "4"], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for w in ("w00", "w01")}
    try:
        deadline = time.monotonic() + 60
        while not (tmp_path / "w01.gen1").exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        time.sleep(1.0)
        os.kill(procs["w01"].pid, signal.SIGKILL)
        out, _ = procs["w00"].communicate(timeout=150)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    assert procs["w00"].returncode == 0, out[-4000:]
    rec = json.loads((tmp_path / "w00.done").read_text())
    assert rec["epochs"] == 4
    assert rec["gens"][0] == [1, 2] and rec["gens"][-1][1] == 1


if __name__ == "__main__":
    _fleet_worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
