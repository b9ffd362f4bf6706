"""The port's dispatch counters (``perf/compile_watch.py``) and kernel
selection layer (``perf/kernels/__init__.py``) against the JAX package's,
on the CPU.

- The same calls through each package's ``CompileWatch.wrap`` give the same
  ``as_dict()`` (the JAX package counts a plain function by first-seen
  signature, as the port counts every function); ``bump_active`` and the
  dispatch observers behave alike.
- A network's ``train`` / ``output`` / ``score`` dispatches and compiles
  equal the JAX network's for the same batches, a ragged batch included;
  the fused blocks count ``fusion.fused_block`` on the owning network, and
  the kernel wrappers ``kernel.plain_<family>`` (the CPU's implementation).
- ``FAMILIES`` are the JAX package's; the card has one implementation of
  each (``candidate_flags() == ()``) and refuses ``pallas_kernels=False``.
- A retrieval index counts its scoring dispatches, flat after warm-up;
  ``obs.absorb_compile_watch`` reads a network's watch;
  ``ParallelInference.stats()`` reports the model's.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.perf.compile_watch as jcw
import deeplearning4j_tpu.perf.pallas as jpallas
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import layers as jlay
from deeplearning4j_tpu.nn.conf import normalization as jnorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.perf.fusion import fuse as jax_fuse

import deeplearning4j_tpu_torch.perf.compile_watch as pcw
from deeplearning4j_tpu_torch import perf
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax, state_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.perf import kernels


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's CPU convolution backward crashes in a process that has run
    XLA:CPU programs; the port's CPU path takes native convolutions here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _host(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _bn_cnn(fused=False):
    """conv(3x3, 4)-BN-relu, dense, softmax over 6 x 6 x 2 images."""
    conf = (JNNC.builder().seed(3).updater(jupd.Sgd(learning_rate=0.1)).list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3), convolution_mode="same",
                                          activation="identity"))
            .layer(jnorm.BatchNormalization())
            .layer(jlay.ActivationLayer(activation="relu"))
            .layer(jlay.DenseLayer(n_out=5, activation="tanh"))
            .layer(jlay.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.convolutional(6, 6, 2)).build())
    return jax_fuse(conf) if fused else conf


def _pair(jconf):
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    pnet.set_params(params_from_jax(_host(jnet.params), device="cpu"),
                    state_from_jax(_host(jnet.state), device="cpu"))
    return jnet, pnet


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, 6, 6, 2)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])


# ------------------------------------------------------------ CompileWatch
def test_wrap_counts_like_the_jax_watch():
    calls = [np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32),
             np.zeros((5, 3), np.float32), np.zeros((4, 3), np.float64),
             np.zeros((4, 3), np.float32)]
    got = {}
    for name, mod in (("port", pcw), ("jax", jcw)):
        w = mod.CompileWatch("t")
        f = w.wrap(lambda a: a.sum(), "f")
        g = w.wrap(lambda a, b: a, "g")
        for a in calls:
            f(a)
        g(calls[0], calls[2])
        g(calls[1], calls[2])
        w.bump("event", 3)
        got[name] = w.as_dict()
        assert w.compiles("f") == 3 and w.dispatches("f") == 5 and w.counter("event") == 3
        assert w.counters("ev") == {"event": 3}
        w.reset()
        assert w.as_dict() == {"compiles": 0, "dispatches": 0, "by_key": {}}
    assert got["port"] == got["jax"]


def test_bump_active_lands_on_the_owning_watch_and_observers_see_calls():
    own = pcw.CompileWatch("own")
    before = pcw.GLOBAL.counter("x.event")
    seen = []

    def observer(key, fn, args, kwargs, compiled):
        seen.append((key, args, compiled))
        raise RuntimeError("observers never break the call")

    pcw.add_dispatch_observer(observer)
    try:
        f = own.wrap(lambda a: pcw.bump_active("x.event") or a, "k")
        assert f(7) == 7 and f(7) == 7
    finally:
        pcw.remove_dispatch_observer(observer)
    f(8)
    pcw.bump_active("x.event")  # outside a watched call: GLOBAL only
    assert own.counter("x.event") == 3
    assert pcw.GLOBAL.counter("x.event") - before == 4
    assert seen == [("k", (7,), 1), ("k", (7,), 0)]
    assert own.compiles("k") == 2  # 7 and 8 are two signatures
    assert isinstance(pcw.backend_compile_events(), int)
    assert perf.compile_watch is pcw


# ---------------------------------------------------------------- networks
@pytest.mark.parametrize("fused", [False, True])
def test_network_counts_equal_the_jax_networks(fused):
    """train dispatches a batch and compiles a shape, output and score
    alike, in both packages; a fused block counts on its own network."""
    jnet, pnet = _pair(_bn_cnn(fused))
    batches = [_batch(4, s) for s in range(3)] + [_batch(3, 9)]
    for x, y in batches:
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
    for x, _ in batches[:2]:
        jnet.output(x)
        pnet.output(x)
    jnet.score_dataset(JaxDataSet(*batches[0]))
    pnet.score_dataset(DataSet(*batches[0]))
    want = jnet.compile_watch.as_dict()
    got = pnet.compile_watch.as_dict()
    assert got["by_key"] == want["by_key"]
    assert got["by_key"]["train"] == {"compiles": 2, "dispatches": 4}
    if fused:
        # the port counts a fused block's every forward (JAX: every trace)
        assert pnet.compile_watch.counter("fusion.fused_block") == 4 + 2 + 1
        # train-mode batch norm runs the kernel family (scoring is inference)
        assert pnet.compile_watch.counter("kernel.plain_bn_act") == 4
        assert pnet.compile_watch.counter("kernel.plain_bn_act_bwd") == 4
    else:
        assert pnet.compile_watch.counters("fusion.") == {}


# -------------------------------------------------------- kernel selection
def test_kernel_families_and_the_cards_one_implementation():
    assert kernels.FAMILIES.keys() == jpallas.FAMILIES.keys()
    assert kernels.candidate_flags() == ()
    assert kernels.selection_snapshot() == {f: "cuda" for f in jpallas.FAMILIES}
    watch = pcw.CompileWatch("k")
    f = watch.wrap(lambda d: kernels.take("adc_pq", torch.device(d)), "take")
    assert f("cuda") is True and f("cpu") is False
    assert watch.counters("kernel.") == {"kernel.cuda_adc_pq": 1, "kernel.plain_adc_pq": 1}
    for flag in (None, True):
        kernels.check_kernels_flag(flag, torch.device("cuda"))
    kernels.check_kernels_flag(False, torch.device("cpu"))
    with pytest.raises(kernels.KernelSelectionError, match="fusion=False"):
        kernels.check_kernels_flag(False, torch.device("cuda"))


def test_meta_kernel_operation_counts_once():
    """A kernel wrapper on meta tensors runs its plain body as one operation
    and launches nothing."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act, flash_attention
    seen = []
    kernels.add_meta_observer(lambda fam, ins, outs: seen.append((fam, len(ins), len(outs))))
    try:
        z = torch.empty((10, 4), device="meta")
        g = torch.empty(4, device="meta")
        launches = bn_act.fwd_launches
        out, mean, var, inv = bn_act.bn_act_fwd("relu", 1e-5, z, g, g)
        q = torch.empty((1, 2, 9, 8), device="meta")
        o, lse = flash_attention.flash_fwd(q, q, q, True)
    finally:
        kernels._meta_observers.clear()
    assert out.shape == (10, 4) and mean.shape == (4,) and out.device.type == "meta"
    assert o.shape == q.shape and lse.shape == (1, 2, 9)
    assert seen == [("bn_act", 3, 4), ("flash_attn_fwd", 3, 2)]
    assert bn_act.fwd_launches == launches


# ------------------------------------------------ indexes, obs, serving
def test_index_search_dispatches_stay_warm():
    from deeplearning4j_tpu_torch.retrieval import BruteForceIndex
    rng = np.random.default_rng(0)
    ix = BruteForceIndex(rng.standard_normal((200, 8)).astype(np.float32), device="cpu")
    warmed = ix.warmup(max_queries=16, ks=(5,))
    compiles = ix.compile_watch.compiles()
    assert compiles == len(warmed) and ix.compile_watch.dispatches() == len(warmed)
    for rows in (1, 3, 8, 11):
        ix.search(rng.standard_normal((rows, 8)).astype(np.float32), 5)
    assert ix.compile_watch.compiles() == compiles  # every live batch was warmed
    assert ix.stats()["compile_watch"]["dispatches"] == len(warmed) + 4


def test_obs_and_parallel_inference_read_a_networks_watch():
    from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, absorb_compile_watch
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    _, pnet = _pair(_bn_cnn(True))
    x, y = _batch(4, 1)
    pnet.fit(DataSet(x, y))
    reg = MetricsRegistry()
    absorb_compile_watch(reg, pnet.compile_watch)
    assert reg.metric("jit_compiles").value == 1
    assert reg.metric("jit_fusion_fused_block").value == 1
    pi = ParallelInference(pnet, inference_mode="sequential", device="cpu")
    try:
        pi.output(x[:3])
        pi.output(x[:2])
        st = pi.stats()
    finally:
        pi.shutdown()
    assert st["model_compiles"] == 2 and st["model_dispatches"] == 3  # train + 2 outputs
    assert st["fusion"] == {"fusion.fused_block": 3}
