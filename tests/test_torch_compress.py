"""Gradient compression in the PyTorch port against the JAX package, on
the CPU.

- Each scheme's ``apply`` on the same numpy gradient tree, two steps (the
  second with a nonzero residual): decoded gradients, residuals and byte
  accounting against the JAX ``apply``. Threshold, top-k and int8 are
  elementwise or exact integer sums and must agree bitwise; 1-bit's
  class means and every scheme's residual norm are float sums in another
  order: a float32 sum of n terms in another order may differ by n
  units of roundoff (2**-24) of the largest term, so they are held within
  n * 2**-24 of the largest magnitude entering the sum (the encoded
  ``g + residual``), n the leaf's size (the tree's for the norm), and 2
  ulps relative.
- The adaptive τ over 10 steps of gradients whose scale drifts: τ and the
  byte counters bitwise every step.
- A compressed ``fit`` (MultiLayerNetwork with Sgd, a graph with Adam)
  against the JAX compressed ``fit``, 3 steps: parameters within 1e-5
  absolute (float32 gradients in another summation order).
- ``compressState.npz`` in a checkpoint zip and a compressed shard set
  written by either package and restored by the other, bitwise, with
  ``state_sha`` equal in both; kill-and-resume bitwise; ``fit_fused`` with
  compression bitwise the per-batch ``fit`` and within 1e-5 of the JAX
  package's ``fit_fused``; ``fit_tbptt_fused`` bitwise the windowed ``fit``.

JAX is imported inside the tests, not at module top.
"""

import io

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager, FaultInjector,
                                                 SimulatedCrash)
from deeplearning4j_tpu_torch.checkpoint import sharded as pshd
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel import compress as pc
from deeplearning4j_tpu_torch.utils import serialization as pser

ULP2 = 2.4e-7  # two float32 ulps, relative
U = 2.0 ** -24  # float32 unit roundoff
TREE_SIZE = 30 + 5 + 15 + 3


def _close(a, b, err_msg="", n=None, scale=0.0):
    """Within n units of roundoff of the larger of ``scale`` and b's
    largest magnitude (n: b's size unless given) and 2 ulps relative; see
    the module docstring."""
    b = np.asarray(b)
    n = b.size if n is None else n
    scale = max(scale, float(np.max(np.abs(b))) if b.size else 0.0)
    np.testing.assert_allclose(a, b, rtol=ULP2, atol=max(n, 1) * U * scale,
                               err_msg=err_msg)


SCHEMES = {
    "threshold": dict(cls="ThresholdCompression", kw=dict(threshold=0.05,
                                                           target_sparsity=0.2)),
    "topk": dict(cls="TopKCompression", kw=dict(ratio=0.2)),
    "int8": dict(cls="Int8Compression", kw={}),
    "int8_chunked": dict(cls="Int8Compression", kw=dict(chunk_size=7)),
    "onebit": dict(cls="OneBitCompression", kw={}),
}
EXACT = {"threshold", "topk", "int8", "int8_chunked"}


def _schemes(name):
    from deeplearning4j_tpu.parallel import compress as jc
    spec = SCHEMES[name]
    return getattr(jc, spec["cls"])(**spec["kw"]), getattr(pc, spec["cls"])(**spec["kw"])


def _grad_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal
    tree = [{"W": g((6, 5)), "b": g((5,))}, {}, {"W": g((5, 3)), "b": g((3,))}]
    # ties at the top-k magnitude and exact zeros
    tree[0]["W"][0, :3] = 2.5
    tree[2]["b"][0] = 0.0
    return [{k: (v * scale).astype(np.float32) for k, v in d.items()} for d in tree]


def _torch_tree(tree):
    return [{k: torch.from_numpy(v.copy()) for k, v in d.items()} for d in tree]


def _flat_state(state):
    """``{path: ndarray}`` of either package's compression state."""
    if isinstance(next(iter(state["acc"].values())), torch.Tensor):
        return {k: v.numpy() for k, v in pc.compress_state_arrays(state).items()}
    from deeplearning4j_tpu.utils.serialization import _flatten_with_paths
    return _flatten_with_paths({k: v for k, v in state.items() if v is not None})


def _assert_state(p_state, j_state, exact, scale=0.0):
    p, j = _flat_state(p_state), _flat_state(j_state)
    assert list(p) == list(j)
    for k in p:
        if exact and not k.startswith("residual") and k != "acc/residual_norm":
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        else:
            _close(p[k], j[k], err_msg=k, scale=scale,
                   n=TREE_SIZE if k == "acc/residual_norm" else None)


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_apply_matches_jax(name):
    import jax.numpy as jnp
    jscheme, pscheme = _schemes(name)
    japply = jscheme.apply  # eager: op for op, as the port runs
    exact = name in EXACT
    g0 = _grad_tree(0)
    jstate = jscheme.init_state([{k: jnp.asarray(v) for k, v in d.items()} for d in g0])
    pstate = pscheme.init_state(_torch_tree(g0))
    for seed in (1, 2):
        g = _grad_tree(seed)
        # the largest |g + residual| any sum reads
        scale = max(float(np.max(np.abs(v))) for d in g for v in d.values()) + max(
            (float(np.max(np.abs(r))) for r in _flat_state(pstate).values()), default=0.0)
        jdec, jstate = japply([{k: jnp.asarray(v) for k, v in d.items()} for d in g], jstate)
        pdec, pstate = pscheme.apply(_torch_tree(g), pstate)
        for pd, jd in zip(pdec, jdec):
            assert set(pd) == set(jd)
            for k in pd:
                if exact:
                    np.testing.assert_array_equal(pd[k].numpy(), np.asarray(jd[k]))
                else:
                    _close(pd[k].numpy(), jd[k], scale=scale)
        _assert_state(pstate, jstate, exact, scale=scale)


def test_adaptive_tau_trajectory_and_bytes():
    """10 steps: the encoded fraction crosses the deadband both ways, so τ
    rises and falls; τ and every byte counter bitwise each step."""
    import jax.numpy as jnp
    jscheme, pscheme = _schemes("threshold")
    japply = jscheme.apply
    g0 = _grad_tree(0)
    jstate = jscheme.init_state([{k: jnp.asarray(v) for k, v in d.items()} for d in g0])
    pstate = pscheme.init_state(_torch_tree(g0))
    taus = []
    for step in range(10):
        g = _grad_tree(10 + step, scale=1e-3 if step < 5 else 5.0)
        _, jstate = japply([{k: jnp.asarray(v) for k, v in d.items()} for d in g], jstate)
        _, pstate = pscheme.apply(_torch_tree(g), pstate)
        _assert_state(pstate, jstate, exact=True)
        taus.append(float(pstate["ctrl"]["tau"]))
    # small gradients: τ falls; large ones: τ rises
    assert taus[4] < 0.05 < taus[9] and taus == sorted(taus[:5], reverse=True) + taus[5:]
    # the dual encoding's accounting: min(4 B/nnz, 2 bits/elt) + 16 B a leaf
    acc = pstate["acc"]
    assert float(acc["dense_bytes"]) == 10 * 4 * (30 + 5 + 15 + 3)
    assert float(acc["last_ratio"]) == pytest.approx(
        float(acc["dense_bytes"]) / 10 / float(acc["last_wire_bytes"]), rel=1e-6)


# ------------------------------------------------------------- networks
def _jax_mln(updater):
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7).updater(updater)
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _jax_graph():
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.graph import GraphBuilder, MergeVertex
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    from deeplearning4j_tpu.optimize.updaters import Adam
    parent = NeuralNetConfiguration.builder().seed(5).updater(Adam(0.02)).weight_init("xavier")
    conf = (GraphBuilder(parent).add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=12, activation="relu"), "in")
            .add_layer("d2", DenseLayer(n_out=12, activation="tanh"), "in")
            .add_vertex("merge", MergeVertex(), "d1", "d2")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "merge")
            .set_outputs("out").set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf).init()


def _to_port(jnet, tmp_path):
    from deeplearning4j_tpu.utils import serialization as jser
    path = tmp_path / "net.zip"
    jser.write_model(jnet, str(path))
    return pser.restore(str(path), device="cpu")


def _batches(n=3, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((batch, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]
        out.append((x, y))
    return out


def _params(net):
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves
    return [t.detach().numpy().copy() for t in tree_leaves(net.params)]


def _jparams(jnet):
    import jax
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(jnet.params)]


def _sorted_leaves(net):
    """Port parameters in the JAX package's flatten order."""
    leaves = pc._leaves(net.params)
    return [t.detach().numpy() for _, t in leaves]


@pytest.mark.parametrize("kind,scheme", [("multilayer", "threshold"), ("graph", "topk")])
def test_compressed_fit_matches_jax(kind, scheme, tmp_path):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.optimize.updaters import Sgd
    from deeplearning4j_tpu.parallel.compress import enable_grad_compression as jenable
    jnet = _jax_mln(Sgd(learning_rate=0.1)) if kind == "multilayer" else _jax_graph()
    pnet = _to_port(jnet, tmp_path)
    jscheme, pscheme = _schemes(scheme)
    jenable(jnet, jscheme)
    pc.enable_grad_compression(pnet, pscheme)
    for x, y in _batches():
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    for a, b in zip(_sorted_leaves(pnet), _jparams(jnet)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    p, j = _flat_state(pnet.compress_state), _flat_state(jnet.compress_state)
    assert list(p) == list(j)
    for k in p:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert pnet.score() == pytest.approx(float(jnet.score()), rel=1e-5)


def _compressed_pair(tmp_path, scheme="threshold"):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.optimize.updaters import Adam
    from deeplearning4j_tpu.parallel.compress import enable_grad_compression as jenable
    jnet = _jax_mln(Adam(0.01))
    jscheme, pscheme = _schemes(scheme)
    jenable(jnet, jscheme)
    for x, y in _batches(2):
        jnet.fit(JDataSet(x, y))
    pnet = _to_port(jnet, tmp_path)  # the model zip carries no compression
    return jnet, pnet, pscheme


def test_compress_state_zip_both_ways(tmp_path):
    from deeplearning4j_tpu.utils import serialization as jser
    jnet, _, _ = _compressed_pair(tmp_path)
    data = jser.checkpoint_zip_bytes(jser.snapshot_training_state(jnet))
    pnet, meta = pser.restore_checkpoint(io.BytesIO(data), device="cpu")
    assert meta["grad_compression"]["@scheme"] == "ThresholdCompression"
    assert pnet.grad_compression == pc.ThresholdCompression(threshold=0.05,
                                                            target_sparsity=0.2)
    _assert_state(pnet.compress_state, jnet.compress_state, exact=True)
    # and back: the port's checkpoint restores in the JAX package
    back = bytes(pser.checkpoint_zip_bytes(pser.snapshot_training_state(pnet)))
    jnet2, jmeta = jser.restore_checkpoint(io.BytesIO(back))
    assert jmeta["has_compress_state"] and jnet2.grad_compression == jnet.grad_compression
    _assert_state(pnet.compress_state, jnet2.compress_state, exact=True)


def test_compressed_shard_set_both_ways(tmp_path):
    from deeplearning4j_tpu.checkpoint import sharded as jshd
    jnet, _, _ = _compressed_pair(tmp_path)
    extra = {"seq": 1, "batch_in_epoch": 0}
    payloads = [jshd.shard_zip_bytes(s, extra) for s in jshd.simulated_shard_snapshots(jnet, 3)]
    pnet, meta = pshd.restore_from_payloads(payloads, device="cpu")
    assert meta["has_compress"]
    _assert_state(pnet.compress_state, jnet.compress_state, exact=True)
    assert pshd.state_sha(pnet) == jshd.state_sha(jnet)
    back = [pshd.shard_zip_bytes(s, extra) for s in pshd.simulated_shard_snapshots(pnet, 2)]
    jnet2, _ = jshd.restore_from_payloads(back)
    assert jshd.state_sha(jnet2) == pshd.state_sha(pnet) == jshd.state_sha(jnet)


def _port_mln(tmp_path):
    from deeplearning4j_tpu.optimize.updaters import Adam
    return _to_port(_jax_mln(Adam(0.01)), tmp_path)


def test_kill_and_resume_is_bitwise(tmp_path):
    data = [DataSet(x, y) for x, y in _batches(4, seed=3)]
    ref = _port_mln(tmp_path)
    pc.enable_grad_compression(ref, pc.ThresholdCompression(target_sparsity=0.1))
    ref.fit(data, num_epochs=2)
    net = _port_mln(tmp_path)
    pc.enable_grad_compression(net, pc.ThresholdCompression(target_sparsity=0.1))
    cm = CheckpointManager(str(tmp_path / "ck"), save_every_n_steps=2, device="cpu",
                           async_write=False)
    net.set_listeners(FaultInjector(kill_at_step=5))
    with pytest.raises(SimulatedCrash):
        net.fit(data, num_epochs=2, checkpoint_manager=cm)
    resumed = CheckpointManager(str(tmp_path / "ck"), device="cpu").restore_latest()
    assert resumed.grad_compression == ref.grad_compression
    resumed.fit(data, num_epochs=2, checkpoint_manager=cm)
    for a, b in zip(_params(resumed), _params(ref)):
        np.testing.assert_array_equal(a, b)
    p, r = _flat_state(resumed.compress_state), _flat_state(ref.compress_state)
    for k in r:
        np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    assert pshd.state_sha(resumed) == pshd.state_sha(ref)


def test_fit_fused_with_compression(tmp_path):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.optimize.updaters import Sgd
    from deeplearning4j_tpu.parallel.compress import enable_grad_compression as jenable
    jnet = _jax_mln(Sgd(learning_rate=0.1))
    a, b = _to_port(jnet, tmp_path), _to_port(jnet, tmp_path)
    jscheme, pscheme = _schemes("int8")
    jenable(jnet, jscheme)
    for net in (a, b):
        pc.enable_grad_compression(net, pscheme)
    batches = _batches(3, seed=4)
    jnet.fit_fused([JDataSet(x, y) for x, y in batches])
    a.fit_fused([DataSet(x, y) for x, y in batches])
    for x, y in batches:
        b.fit(DataSet(x, y))
    for u, v in zip(_params(a), _params(b)):
        np.testing.assert_array_equal(u, v)
    for u, v in zip(_sorted_leaves(a), _jparams(jnet)):
        np.testing.assert_allclose(u, v, rtol=0, atol=1e-5)


def test_fit_tbptt_fused_with_compression():
    """A GravesLSTM network with tBPTT: fit_tbptt_fused with compression is
    the per-window fit bitwise, the state advancing once a window."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.recurrent import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import RmsProp
    conf = (NeuralNetConfiguration.builder().seed(11).updater(RmsProp(1e-2))
            .weight_init("xavier").list()
            .layer(GravesLSTM(n_out=6))
            .layer(RnnOutputLayer(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(3)).backprop_type("tbptt", 4, 4).build())
    nets = [MultiLayerNetwork(conf, device="cpu").init() for _ in range(2)]
    for n in nets:
        pc.enable_grad_compression(n, pc.TopKCompression(ratio=0.3))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 12, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 12))]
    nets[0].fit_tbptt_fused(x, y)
    nets[1].fit(DataSet(x, y))
    assert nets[0].iteration == nets[1].iteration == 3
    for u, v in zip(_params(nets[0]), _params(nets[1])):
        np.testing.assert_array_equal(u, v)
    for n in nets:
        assert float(n.compress_state["acc"]["steps"]) == 3.0


def test_guards_stats_and_overhead(tmp_path):
    from deeplearning4j_tpu_torch.obs.exporters import prometheus_text
    net = _port_mln(tmp_path)
    with pytest.raises(ValueError, match="error_feedback=False"):
        pc.enable_grad_compression(net, pc.OneBitCompression(error_feedback=False))
    pc.enable_grad_compression(net, pc.Int8Compression())
    with pytest.raises(ValueError, match="refusing to switch"):
        pc.enable_grad_compression(net, pc.OneBitCompression())
    assert pc.compression_stats(net) is None
    x, y = _batches(1)[0]
    net.fit(DataSet(x, y))
    stats = pc.compression_stats(net)
    # int8: a byte an element, a 4-byte scale and a 16-byte header a leaf
    n, leaves = 4 * 16 + 16 + 16 * 3 + 3, 4
    assert stats["steps"] == 1.0
    assert stats["last_ratio"] == pytest.approx(4 * n / (n + 20 * leaves), rel=1e-6)
    before = {k: v.clone() for k, v in pc.compress_state_arrays(net.compress_state).items()}
    assert pc.measure_compression_overhead(net, repeats=2) > 0.0
    after = pc.compress_state_arrays(net.compress_state)
    assert all(torch.equal(before[k], after[k]) for k in before)  # probe changes nothing
    text = prometheus_text()
    assert "grad_compress_ratio" in text and "grad_compress_bytes_wire_total" in text
    # a scheme round-trips through its config
    cfg = pc.ThresholdCompression(threshold=0.01).to_config()
    assert pc.GradientCompression.from_config(cfg) == pc.ThresholdCompression(threshold=0.01)
