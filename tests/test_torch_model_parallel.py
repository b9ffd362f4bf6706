"""Model and sequence parallelism of the port across gloo ranks on the CPU,
against the JAX package on meshes of the same size over the 8 forced CPU
devices.

Two spawns of worker processes (this file run as a script, ``python
tests/test_torch_model_parallel.py <world> <rank> <port> <tmp>``; the
workers import torch and the port only), one of 2 ranks and one of 4, each
running every scenario in order and writing its arrays to ``rank<r>.npz``:

- ``ring_self_attention`` and ``ulysses_self_attention`` on each rank's
  time block of one (2, 4, 32, 8) float32 q, k, v, causal and not: the
  blocks' outputs, and the gradients of the sum of every rank's squared
  output, held against the JAX functions on a mesh of the same size
  (outputs rtol 2e-4 / atol 2e-5, gradients rtol 3e-4 / atol 3e-5: the
  tolerances of ``tests/test_parallel.py``; the online softmax sums in
  another order). Ulysses at 4 heads over 4 ranks, and its refusal of 3
  heads over 2 or 4 ranks with the JAX message's facts.
- ``ParallelWrapper(tensor_parallel=True)`` on a (1, 2) mesh at 2 ranks
  and a (2, 2) mesh at 4: 3 Adam steps of ``tests/test_parallel.py``'s
  tensor-parallel net, plain and with ``ThresholdCompression``, against
  the JAX ``ParallelWrapper(tensor_parallel=True)`` on its (4, 2) mesh
  (rtol 2e-4 / atol 1e-5, that file's replicated-numerics tolerance). A
  listener checks that, during the step, each rank holds slices of the
  sharded leaves, of Adam's slots and of the residual, and whole leaves at
  each epoch's end; after ``fit`` every rank holds the same whole leaves.
  The plain run checkpoints every 2 steps: the leaves are whole only for
  the step that saves, and rank 0's checkpoint holds them whole.
- ``GPipeTrainer`` at S = 2 and 4 (6 microbatches of 4 rows, width 8):
  ``tests/test_pipeline.py``'s four contracts against the JAX pipeline on
  a stage mesh of S devices: forward (rtol / atol 2e-5), gradients (rtol
  5e-4 / atol 5e-5), 5 Sgd steps of losses (rtol 1e-4) and parameters
  (rtol 1e-3 / atol 1e-4), and one stage against the sequential block (in
  this process, rtol 1e-5 / atol 1e-6).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, T, D = 2, 4, 32, 8                 # attention: (batch, heads, time, head dim)
S_MB, M_MB, PD = 4, 6, 8                 # pipeline: rows a microbatch, microbatches, width
TP_STEPS = 3
PIPE_STEPS = 5


def _qkv():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3)]


def _tp_data():
    rng = np.random.default_rng(0)
    x = rng.random((16, 4), np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    return x, y


def _stacked(S, seed=0):
    rng = np.random.default_rng(seed)
    return {"W": rng.standard_normal((S, PD, PD), np.float32) * np.float32(0.4),
            "b": rng.standard_normal((S, PD), np.float32) * np.float32(0.1)}


def _pipe_data():
    rng = np.random.default_rng(2)
    return (rng.standard_normal((M_MB, S_MB, PD)).astype(np.float32),
            rng.standard_normal((M_MB, S_MB, PD)).astype(np.float32))


def _train_targets(S):
    """A learnable target: a fixed random stack's outputs (numpy)."""
    xs = np.random.default_rng(3).standard_normal((M_MB, S_MB, PD)).astype(np.float32)
    p = _stacked(S, seed=9)
    y = xs
    for s in range(S):
        y = np.tanh(y @ p["W"][s] + p["b"][s]).astype(np.float32)
    return xs, y


# ---------------------------------------------------------------- workers
class _SliceProbe:
    """Listener: the shapes a rank holds while it steps."""

    def __init__(self):
        self.seen = self.epoch_end = None

    def iteration_done(self, model, iteration, epoch):
        if self.seen is None:
            cs = model.compress_state
            self.seen = {"W0": list(model.params[0]["W"].shape),
                         "b0": list(model.params[0]["b"].shape),
                         "mu_W0": list(model.opt_state[0]["mu"]["W"].shape),
                         "res_W0": (None if cs is None else
                                    list(cs["residual"][0]["W"].shape))}

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        self.epoch_end = list(model.params[0]["W"].shape)


def _probe_manager(directory):
    """A CheckpointManager saving every 2 steps that records the W0 shape
    each ``step_end`` sees and the W0 each save takes."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager

    class ProbeManager(CheckpointManager):
        def __init__(self):
            super().__init__(directory, save_every_n_steps=2, device="cpu", async_write=False,
                             barrier_timeout_s=60)
            self.step_shapes, self.saved = [], []

        def step_end(self, model, batch_in_epoch=None, due=None):
            self.step_shapes.append(list(model.params[0]["W"].shape))
            super().step_end(model, batch_in_epoch, due)

        def save(self, model, metric=None, wait=False):
            self.saved.append(model.params[0]["W"].detach().clone())
            return super().save(model, metric, wait)

    return ProbeManager()


def _worker(world, rank, port, tmp):
    import datetime

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import (GPipeTrainer, ParallelWrapper,
                                                   ThresholdCompression, make_mesh,
                                                   make_pipeline_mesh, pipeline_apply,
                                                   ring_self_attention, ulysses_self_attention)
    from deeplearning4j_tpu_torch.parallel.compress import _leaves
    from deeplearning4j_tpu_torch.utils.serialization import restore

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    out, meta = {}, {}
    # sequence parallelism: this rank's time block
    k_t = T // world
    blocks = [torch.from_numpy(a[:, :, rank * k_t:(rank + 1) * k_t].copy()) for a in _qkv()]
    for name, fn in (("ring", ring_self_attention), ("uly", ulysses_self_attention)):
        for causal in (False, True):
            q, k, v = (b.clone().requires_grad_(True) for b in blocks)
            o = fn(q, k, v, causal=causal)
            (o * o).sum().backward()
            tag = f"{name}_{int(causal)}"
            out[f"{tag}_o"] = o.detach().numpy()
            for g, t in (("dq", q), ("dk", k), ("dv", v)):
                out[f"{tag}_{g}"] = t.grad.numpy()
    try:
        ulysses_self_attention(*(b[:, :3] for b in blocks))
    except ValueError as e:
        meta["uly_refusal"] = str(e)

    # tensor parallelism: (1, 2) at two ranks, (2, 2) at four
    x, y = _tp_data()
    for tag, comp in (("tp", None), ("tpc", ThresholdCompression())):
        net = restore(os.path.join(tmp, "tp.zip"), device="cpu")
        probe = _SliceProbe()
        net.set_listeners(probe)
        pw = ParallelWrapper(net, mesh=make_mesh(tp=2, device="cpu"), tensor_parallel=True,
                             grad_compression=comp)
        cm = _probe_manager(os.path.join(tmp, "ck")) if comp is None else None
        pw.fit(DataSet(x, y), num_epochs=TP_STEPS, checkpoint_manager=cm)
        if cm is not None:
            cm.close()
            meta["tp_ckpt"] = {"step_shapes": cm.step_shapes,
                               "saved": [list(w.shape) for w in cm.saved]}
            if rank == 0:
                back = cm.restore_latest()
                meta["tp_ckpt"]["restored_equal"] = bool(
                    torch.equal(back.params[0]["W"], cm.saved[-1]))
        meta[f"{tag}_slices"] = dict(probe.seen, epoch_end=probe.epoch_end)
        meta[f"{tag}_mesh"] = pw.mesh.shape
        for i, (_, leaf) in enumerate(_leaves(net.params)):
            out[f"{tag}_leaf{i}"] = leaf.detach().numpy()

    # pipeline parallelism: S = world stages
    S = world
    mesh = make_pipeline_mesh(S, device="cpu")

    def block_fn(p, xx):
        return torch.tanh(xx @ p["W"] + p["b"])

    tr = GPipeTrainer(block_fn, lambda pred, yy: torch.mean((pred - yy) ** 2), Sgd(0.1), mesh)
    params = tr.place(_stacked(S))
    xs, ys = _pipe_data()
    out["pipe_fwd"] = pipeline_apply(block_fn, params, xs, mesh).numpy()
    leaves = {kk: v.clone().requires_grad_(True) for kk, v in params.items()}
    preds = pipeline_apply(block_fn, leaves, xs, mesh)
    torch.mean((preds - torch.from_numpy(ys)) ** 2).backward()
    for kk, v in leaves.items():
        out[f"pipe_grad_{kk}"] = v.grad.numpy()
    txs, tys = _train_targets(S)
    opt = tr.init_opt(params)
    losses = []
    for _ in range(PIPE_STEPS):
        params, opt, loss = tr.step(params, opt, txs, tys)
        losses.append(float(loss))
    meta["pipe_losses"] = losses
    for kk, v in params.items():
        out[f"pipe_param_{kk}"] = v.numpy()

    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_tp_net():
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.builder()
            .seed(3).updater(Adam(0.02)).weight_init("xavier").list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return MultiLayerNetwork(conf).init()


def _jax_references(world):
    """What the workers are held to, on JAX meshes of the same size."""
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
    from deeplearning4j_tpu.parallel.compress import ThresholdCompression as JThreshold
    from deeplearning4j_tpu.parallel.mesh import make_mesh
    from deeplearning4j_tpu.parallel.pipeline import (GPipeTrainer, make_pipeline_mesh,
                                                      pipeline_apply, stage_shardings)
    from deeplearning4j_tpu.parallel.ring_attention import ring_self_attention
    from deeplearning4j_tpu.parallel.trainer import ParallelWrapper
    from deeplearning4j_tpu.parallel.ulysses import ulysses_self_attention

    ref = {}
    q, k, v = (jnp.asarray(a) for a in _qkv())
    mesh = make_mesh(devices=jax.devices()[:world])
    for name, fn in (("ring", ring_self_attention), ("uly", ulysses_self_attention)):
        for causal in (False, True):
            tag = f"{name}_{int(causal)}"

            def attend(qq, kk, vv, fn=fn, causal=causal):
                return fn(qq, kk, vv, mesh, causal=causal)

            def loss(qq, kk, vv, attend=attend):
                return jnp.sum(attend(qq, kk, vv) ** 2)

            # under jit: eager shard_map compiles every primitive apart
            ref[f"{tag}_o"] = np.asarray(jax.jit(attend)(q, k, v))
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
            for g, a in zip(("dq", "dk", "dv"), grads):
                ref[f"{tag}_{g}"] = np.asarray(a)
    try:
        ulysses_self_attention(q[:, :3], k[:, :3], v[:, :3], mesh)
    except ValueError as e:
        ref["uly_refusal"] = str(e)

    x, y = _tp_data()
    for tag, comp in (("tp", None), ("tpc", JThreshold())):
        net = _jax_tp_net()
        ParallelWrapper(net, mesh=make_mesh(tp=2), tensor_parallel=True,
                        grad_compression=comp).fit(JDataSet(x, y), num_epochs=TP_STEPS)
        ref[tag] = [np.asarray(a) for a in jax.tree_util.tree_leaves(net.params)]

    S = world
    pmesh = make_pipeline_mesh(S)

    def block_fn(p, xx):
        return jnp.tanh(xx @ p["W"] + p["b"])

    p0 = {kk: jnp.asarray(a) for kk, a in _stacked(S).items()}
    placed = jax.device_put(p0, stage_shardings(pmesh, p0))
    xs, ys = _pipe_data()

    def forward(p):
        return pipeline_apply(block_fn, p, jnp.asarray(xs), pmesh)

    def loss_pipe(p):
        return jnp.mean((forward(p) - jnp.asarray(ys)) ** 2)

    with pmesh:
        ref["pipe_fwd"] = np.asarray(jax.jit(forward)(placed))
        g = jax.jit(jax.grad(loss_pipe))(placed)
    ref["pipe_grad"] = {kk: np.asarray(a) for kk, a in g.items()}
    tr = GPipeTrainer(block_fn, lambda pred, yy: jnp.mean((pred - yy) ** 2),
                      JSgd(learning_rate=0.1), mesh=pmesh)
    params = tr.place(p0)
    opt = tr.init_opt(params)
    txs, tys = _train_targets(S)
    losses = []
    for _ in range(PIPE_STEPS):
        params, opt, loss = tr.step(params, opt, txs, tys)
        losses.append(float(loss))
    ref["pipe_losses"] = losses
    ref["pipe_param"] = {kk: np.asarray(a) for kk, a in params.items()}
    del optax
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    """One spawn of ``world`` gloo ranks; the JAX references run while the
    workers do."""
    from deeplearning4j_tpu.utils import serialization as jser
    world = request.param
    tmp = tmp_path_factory.mktemp(f"mp{world}")
    jser.write_model(_jax_tp_net(), str(tmp / "tp.zip"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(world),
                               str(rank), str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    ref = _jax_references(world)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers timed out:\n" + "\n".join(o[-3000:] for o in outs))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-4000:]}"
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    meta = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    return world, got, meta, ref


@pytest.mark.parametrize("name", ["ring", "uly"])
def test_sequence_parallel_attention_matches_jax(ranks, name):
    world, got, meta, ref = ranks
    for causal in (0, 1):
        tag = f"{name}_{causal}"
        whole = np.concatenate([g[f"{tag}_o"] for g in got], axis=2)
        np.testing.assert_allclose(whole, ref[f"{tag}_o"], rtol=2e-4, atol=2e-5,
                                   err_msg=f"{tag} output at {world} ranks")
        for d in ("dq", "dk", "dv"):
            grad = np.concatenate([g[f"{tag}_{d}"] for g in got], axis=2)
            np.testing.assert_allclose(grad, ref[f"{tag}_{d}"], rtol=3e-4, atol=3e-5,
                                       err_msg=f"{tag} {d} at {world} ranks")
    if name == "uly":
        for m in meta:
            msg = m["uly_refusal"]
            assert "divisible" in msg and "(3)" in msg and f"({world})" in msg, msg
        assert "divisible" in ref["uly_refusal"]


@pytest.mark.parametrize("tag", ["tp", "tpc"])
def test_tensor_parallel_matches_jax_and_holds_slices(ranks, tag):
    world, got, meta, ref = ranks
    dp = world // 2
    for m in meta:
        assert m[f"{tag}_mesh"] == {"data": dp, "model": 2}
        seen = m[f"{tag}_slices"]
        # (4, 32) kernel and (32,) bias sharded on 'model': each rank half
        assert seen["W0"] == [4, 16] and seen["b0"] == [16] and seen["mu_W0"] == [4, 16]
        assert seen["res_W0"] == (None if tag == "tp" else [4, 16])
        # the epoch-end listeners see whole leaves
        assert seen["epoch_end"] == [4, 32]
    if tag == "tp":
        # gathered whole only for the save (after step 2 of 3), and the
        # checkpoint rank 0 wrote holds that whole leaf
        for m in meta:
            assert m["tp_ckpt"]["step_shapes"] == [[4, 16], [4, 32], [4, 16]]
            assert m["tp_ckpt"]["saved"] == [[4, 32]]
        assert meta[0]["tp_ckpt"]["restored_equal"]
    want = ref[tag]
    for r in range(world):
        leaves = [got[r][f"{tag}_leaf{i}"] for i in range(len(want))]
        for a, b in zip(leaves, want):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{tag} rank {r} at {world} ranks")
        for a, b in zip(leaves, [got[0][f"{tag}_leaf{i}"] for i in range(len(want))]):
            np.testing.assert_array_equal(a, b)


def test_gpipe_matches_jax_pipeline(ranks):
    world, got, meta, ref = ranks
    for g in got:
        np.testing.assert_allclose(g["pipe_fwd"], ref["pipe_fwd"], rtol=2e-5, atol=2e-5)
    for k in ("W", "b"):
        grad = np.concatenate([g[f"pipe_grad_{k}"] for g in got])
        np.testing.assert_allclose(grad, ref["pipe_grad"][k], rtol=5e-4, atol=5e-5,
                                   err_msg=f"grad {k} at S = {world}")
        param = np.concatenate([g[f"pipe_param_{k}"] for g in got])
        np.testing.assert_allclose(param, ref["pipe_param"][k], rtol=1e-3, atol=1e-4,
                                   err_msg=f"params {k} after {PIPE_STEPS} steps")
    for m in meta:
        np.testing.assert_allclose(m["pipe_losses"], ref["pipe_losses"], rtol=1e-4)
        assert m["pipe_losses"][-1] < m["pipe_losses"][0]


def test_tensor_parallel_at_one_rank_is_the_plain_step(tmp_path):
    """A model axis of one rank: the placement is the identity and the run
    is the replicated wrapper's, bitwise."""
    import torch

    from deeplearning4j_tpu.utils import serialization as jser
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.compress import _leaves
    from deeplearning4j_tpu_torch.utils.serialization import restore
    path = str(tmp_path / "tp.zip")
    jser.write_model(_jax_tp_net(), path)
    x, y = _tp_data()
    nets = [restore(path, device="cpu") for _ in range(2)]
    ParallelWrapper(nets[0]).fit(DataSet(x, y), num_epochs=TP_STEPS)
    pw = ParallelWrapper(nets[1], tensor_parallel=True)
    pw.fit(DataSet(x, y), num_epochs=TP_STEPS)
    assert pw._tp is None and nets[1]._tp is None  # whole again after fit
    for (_, a), (_, b) in zip(_leaves(nets[0].params), _leaves(nets[1].params)):
        assert torch.equal(a, b)


def test_pipeline_single_stage_degenerates():
    import jax
    import jax.numpy as jnp
    import torch

    from deeplearning4j_tpu.parallel.pipeline import make_pipeline_mesh as jmesh
    from deeplearning4j_tpu.parallel.pipeline import pipeline_apply as japply
    from deeplearning4j_tpu.parallel.pipeline import stage_shardings
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import (GPipeTrainer, make_pipeline_mesh,
                                                   pipeline_apply)

    p1 = {k: a[:1] for k, a in _stacked(4).items()}
    xs = np.random.default_rng(4).standard_normal((3, S_MB, PD)).astype(np.float32)
    mesh = make_pipeline_mesh(1, device="cpu")

    def block_fn(p, x):
        return torch.tanh(x @ p["W"] + p["b"])

    tr = GPipeTrainer(block_fn, lambda a, b: torch.mean((a - b) ** 2), Sgd(0.1), mesh)
    got = pipeline_apply(block_fn, tr.place(p1), xs, mesh).numpy()
    want = np.stack([np.tanh(x @ p1["W"][0] + p1["b"][0]) for x in xs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jm = jmesh(1)
    jp = jax.device_put({k: jnp.asarray(a) for k, a in p1.items()},
                        stage_shardings(jm, {k: jnp.asarray(a) for k, a in p1.items()}))
    with jm:
        jgot = np.asarray(japply(lambda p, x: jnp.tanh(x @ p["W"] + p["b"]), jp,
                                 jnp.asarray(xs), jm))
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
