"""Two ranks over gloo on the CPU: the port's data-parallel step across
processes against the JAX package's 8-device data-parallel step on the
same global batches.

One spawn of two worker processes (this file run as a script; the workers
import torch and the port only) runs every scenario in order:

- ``bn``: a graph with batch norm and Adam through ``ClusterTrainer.fit``
  on a global iterator (each rank its 8 rows of 16), 3 steps, against the
  JAX ``ParallelWrapper`` over its 8-device mesh: parameters and running
  statistics within 1e-4 (Adam's steps are about lr in size whatever the
  gradient's roundoff). The statistics must be the global batch's: with
  per-rank statistics the ranks' ``state_sha`` differ and the batch
  norm's beta misses the JAX package's by 4.2e-3, 42 times the limit. Then the
  fused block's plain forward and backward (``fused_bn_act_train``) on
  each rank's rows of a (16, 6) batch against the whole batch in one
  process, within 1e-6.
- ``unequal``: ranks feeding 4 and 2 rows both raise UnequalShardError.
- ``ckpt``: a sharded CheckpointManager at world 2 (rank 0 writes, both
  barrier), whose newest set the JAX package's manager restores bitwise.
- ``compressed``: a 2-rank fit with ThresholdCompression against the JAX
  compressed fit on the global batch, parameters within 1e-5.

Every scenario checks that both ranks end with the same ``state_sha``.
A second spawn checks that a rank whose peer stops taking part raises
CollectiveTimeoutError within the watchdog's bound.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL, STEPS = 16, 3


def _xy(n, seed, n_in=4, n_out=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n_in)).astype(np.float32),
            np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)])


def _global_batches(seed0=0, steps=STEPS):
    return [_xy(GLOBAL, seed0 + s) for s in range(steps)]


# ---------------------------------------------------------------- workers
def _worker(mode, rank, port, tmp):
    import datetime

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import (ClusterTrainer, CollectiveTimeoutError,
                                                   ThresholdCompression, UnequalShardError)
    from deeplearning4j_tpu_torch.utils import serialization as pser
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    out = {}

    def params_of(net):
        from deeplearning4j_tpu_torch.utils.serialization import _flat
        return {k: v.detach().numpy() for k, v in _flat([net.params, net.state], "",
                                                        {}).items()}

    def shas():
        got = [None, None]
        dist.all_gather_object(got, out["sha"])
        return got

    if mode == "deadpeer":
        net = pser.restore(os.path.join(tmp, "mln.zip"), device="cpu")
        batches = [DataSet(*_xy(4, 100 + s)) for s in range(6)]
        ct = ClusterTrainer(net)
        if rank == 1:
            ct.fit_local_shard(batches[:1])
            time.sleep(3)  # alive, but takes no further part
            os._exit(0)
        t0 = time.monotonic()
        try:
            ct.fit_local_shard(batches, collective_timeout_s=1.0, watchdog_every=1)
            msg = "no timeout"
        except CollectiveTimeoutError as e:
            msg = str(e)
        with open(os.path.join(tmp, "deadpeer.json"), "w") as f:
            json.dump({"msg": msg, "elapsed": time.monotonic() - t0}, f)
        os._exit(0)  # the wedged all-reduce thread cannot be joined

    # -- bn: a graph with batch norm and Adam over the global iterator
    net = pser.restore(os.path.join(tmp, "bn.zip"), device="cpu")
    ClusterTrainer(net).fit([DataSet(x, y) for x, y in _global_batches()])
    out["sha"] = state_sha(net)
    out["bn_shas"] = shas()
    if rank == 0:
        np.savez(os.path.join(tmp, "bn_params.npz"), **params_of(net))

    # the fused block's plain forward and backward across the two ranks
    from deeplearning4j_tpu_torch.nn import data_parallel
    from deeplearning4j_tpu_torch.nn.conf.convolutional import fused_bn_act_train
    rng = np.random.default_rng(42)
    z = torch.from_numpy(rng.standard_normal((GLOBAL, 6)).astype(np.float32) * 3 + 1)
    w = torch.from_numpy(rng.standard_normal((GLOBAL, 6)).astype(np.float32))
    gamma = torch.linspace(0.5, 1.5, 6)
    beta = torch.linspace(-0.2, 0.3, 6)

    def run(zz, ww):
        zz = zz.clone().requires_grad_(True)
        g, b = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)
        o, mean, var = fused_bn_act_train("relu", 1e-5, zz, g, b)
        # each rank's loss is the mean over its rows, as a step's is
        (o * ww).sum().div(zz.shape[0]).backward()
        return o.detach(), mean, var, zz.grad, g.grad, b.grad

    full = run(z, w)  # no data group: the whole batch in this process
    rows = slice(rank * GLOBAL // 2, (rank + 1) * GLOBAL // 2)
    with data_parallel.data_group(None):
        part = run(z[rows], w[rows])
    avg = [t.clone() for t in part[4:]]
    for t in avg:
        dist.all_reduce(t)
        t /= 2  # the step's mean over ranks
    errs = {"out": (part[0] - full[0][rows]).abs().max().item(),
            "mean": (part[1] - full[1]).abs().max().item(),
            "var": (part[2] - full[2]).abs().max().item(),
            # dz of a mean-over-ranks loss is half the rank's own
            "dz": (part[3] / 2 - full[3][rows]).abs().max().item(),
            "dgamma": (avg[0] - full[4]).abs().max().item(),
            "dbeta": (avg[1] - full[5]).abs().max().item()}
    out["fused_errs"] = errs

    # -- unequal shards: both ranks raise before any step
    net = pser.restore(os.path.join(tmp, "mln.zip"), device="cpu")
    try:
        ClusterTrainer(net).fit_local_shard([DataSet(*_xy(4 if rank == 0 else 2, 7))])
        out["unequal"] = "trained"
    except UnequalShardError as e:
        out["unequal"] = str(e)

    # -- checkpoints at world 2: rank 0 writes, both barrier
    net = pser.restore(os.path.join(tmp, "mln.zip"), device="cpu")
    cm = CheckpointManager(os.path.join(tmp, "ck"), sharded=True, save_every_n_steps=2,
                           device="cpu", async_write=False, barrier_timeout_s=60)
    ClusterTrainer(net).fit([DataSet(x, y) for x, y in _global_batches(10, 4)],
                            checkpoint_manager=cm)
    out["ckpt_saves"] = cm.saves_committed
    out["sha"] = state_sha(net)
    out["ckpt_shas"] = shas()
    if rank == 0:
        np.savez(os.path.join(tmp, "ckpt_params.npz"), **params_of(net))

    # -- a compressed fit over both ranks
    net = pser.restore(os.path.join(tmp, "mln.zip"), device="cpu")
    ClusterTrainer(net, grad_compression=ThresholdCompression()).fit(
        [DataSet(x, y) for x, y in _global_batches(20)])
    out["sha"] = state_sha(net)
    out["comp_shas"] = shas()
    out["tau"] = float(net.compress_state["ctrl"]["tau"])
    if rank == 0:
        np.savez(os.path.join(tmp, "comp_params.npz"), **params_of(net))

    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode, tmp):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(rank),
                              str(port), str(tmp)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]


def _wait(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers timed out:\n" + "\n".join(o[-3000:] for o in outs))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-4000:]}"
    return outs


def _jax_nets():
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.graph import GraphBuilder
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.optimize.updaters import Adam, Sgd
    parent = NeuralNetConfiguration.builder().seed(5).updater(Adam(0.01)).weight_init("xavier")
    gconf = (GraphBuilder(parent).add_inputs("in")
             .add_layer("d1", DenseLayer(n_out=8, activation="tanh"), "in")
             .add_layer("bn", BatchNormalization(), "d1")
             .add_layer("d2", DenseLayer(n_out=8, activation="relu"), "bn")
             .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "d2")
             .set_outputs("out").set_input_types(InputType.feed_forward(4)).build())
    mconf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(learning_rate=0.1))
             .weight_init("xavier").list()
             .layer(DenseLayer(n_out=16, activation="tanh"))
             .layer(OutputLayer(n_out=3, loss="mcxent"))
             .set_input_type(InputType.feed_forward(4)).build())
    return (lambda: ComputationGraph(gconf).init()), (lambda: MultiLayerNetwork(mconf).init())


def _flat_jax(net):
    from deeplearning4j_tpu.utils.serialization import _flatten_with_paths
    return _flatten_with_paths([net.params, net.state])


def test_two_ranks_match_the_jax_mesh(tmp_path):
    from deeplearning4j_tpu.checkpoint import CheckpointManager as JCM
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.parallel.compress import ThresholdCompression as JThreshold
    from deeplearning4j_tpu.parallel.mesh import make_mesh
    from deeplearning4j_tpu.parallel.trainer import ParallelWrapper as JPW
    from deeplearning4j_tpu.utils import serialization as jser
    graph, mln = _jax_nets()
    jser.write_model(graph(), str(tmp_path / "bn.zip"))
    jser.write_model(mln(), str(tmp_path / "mln.zip"))
    procs = _spawn("scenarios", tmp_path)
    # the references run while the workers do
    ref_bn = graph()
    JPW(ref_bn, mesh=make_mesh()).fit([JDataSet(x, y) for x, y in _global_batches()])
    ref_comp = mln()
    JPW(ref_comp, mesh=make_mesh(), grad_compression=JThreshold()).fit(
        [JDataSet(x, y) for x, y in _global_batches(20)])
    _wait(procs, timeout=240)
    r = [json.loads((tmp_path / f"rank{k}.json").read_text()) for k in (0, 1)]
    for key in ("bn_shas", "ckpt_shas", "comp_shas"):
        assert r[0][key] == r[1][key] and r[0][key][0] == r[0][key][1], key

    got = dict(np.load(tmp_path / "bn_params.npz"))
    want = _flat_jax(ref_bn)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    for rank in (0, 1):
        for name, err in r[rank]["fused_errs"].items():
            assert err < 1e-6, (rank, name, err)

    for rank in (0, 1):
        assert "p0=4, p1=2" in r[rank]["unequal"]

    assert r[0]["ckpt_saves"] == 2 and r[1]["ckpt_saves"] == 0
    restored = JCM(str(tmp_path / "ck")).restore_latest()
    assert restored.iteration == 4
    got = dict(np.load(tmp_path / "ckpt_params.npz"))
    for k, v in _flat_jax(restored).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    got = dict(np.load(tmp_path / "comp_params.npz"))
    for k, v in _flat_jax(ref_comp).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert r[0]["tau"] == pytest.approx(float(ref_comp.compress_state["ctrl"]["tau"]))


def test_watchdog_fires_on_a_silent_peer(tmp_path):
    from deeplearning4j_tpu.utils import serialization as jser
    jser.write_model(_jax_nets()[1](), str(tmp_path / "mln.zip"))
    procs = _spawn("deadpeer", tmp_path)
    _wait(procs, timeout=120)
    rec = json.loads((tmp_path / "deadpeer.json").read_text())
    assert "did not complete within 1s" in rec["msg"] and "process 0/2" in rec["msg"]
    assert rec["elapsed"] < 1.0 + 2.0  # the deadline, plus the first step's time


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
