"""Checkpoint hot swap in the port's ``ParallelInference``, over a store the
JAX package's ``CheckpointManager`` wrote, on the CPU.

A JAX network trains a step, commits, trains, commits; the port serves the
store through its own ``CheckpointManager`` and swaps each newer commit in
by hand (``poll_checkpoint``), beside a JAX ``ParallelInference`` polling
the same directory. Each swap must land the JAX-restored network's answers;
a calibration record is re-applied on every swap; a torn newest checkpoint
neither re-swaps nor downgrades; a store holding another architecture is
refused; and requests in flight across a swap each see one whole network.
``CheckpointManager.latest_step`` / ``refresh`` read the same journal as the
JAX manager's, and the poll backoff, warm-up and learned bucket ladder
follow the JAX package's.

Tolerance: outputs within 1e-6 absolute of the JAX-restored network's (the
same weights; torch and XLA sum the matmuls in another order).
"""

import os
import threading

import numpy as np
import pytest

from deeplearning4j_tpu.checkpoint import CheckpointManager as JaxCM
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize.updaters import Sgd
from deeplearning4j_tpu.parallel.inference import ParallelInference as JaxPI
from deeplearning4j_tpu.perf.bucketing import BucketPolicy as JaxBucketPolicy
from deeplearning4j_tpu.quant import calibrate as jax_calibrate
from deeplearning4j_tpu.quant import quantize as jax_quantize

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.checkpoint.faults import tear_file
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.quant import CalibrationRecord
from deeplearning4j_tpu_torch.quant.lowering import is_quantized

ATOL = 1e-6


def _jax_net(seed=11, hidden=16):
    conf = (JaxNNC.builder().seed(seed).updater(Sgd(learning_rate=0.5))
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=hidden, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.random((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return JaxDataSet(x, y)


def _commit(jnet, jcm, seed):
    """One training step, then a synchronous commit; returns its file."""
    jnet.fit(_batch(seed))
    name = jcm.save(jnet)
    jcm.flush()
    return name


def _jax_restored(directory):
    return JaxCM(directory).restore_latest(load_updater=False)


X = np.random.default_rng(99).random((5, 4)).astype(np.float32)


def test_swaps_follow_the_jax_store_and_never_downgrade(tmp_path):
    d = str(tmp_path / "store")
    jnet, jcm = _jax_net(), JaxCM(d, async_write=False)
    _commit(jnet, jcm, 1)
    pcm = CheckpointManager(d, device="cpu")
    pnet = pcm.restore_latest(load_updater=False)
    pi = ParallelInference(pnet, device="cpu", checkpoint_manager=pcm)
    jpi = JaxPI(_jax_restored(d), checkpoint_manager=JaxCM(d))
    try:
        assert pi.stats()["hot_swap"]["current_checkpoint_step"] == 1
        assert pi.poll_checkpoint() is jpi.poll_checkpoint() is False
        np.testing.assert_allclose(pi.output(X), np.asarray(jpi.output(X)), atol=ATOL, rtol=0)
        step1 = pi.output(X)

        _commit(jnet, jcm, 2)
        assert pi.poll_checkpoint() is jpi.poll_checkpoint() is True
        want = np.asarray(_jax_restored(d).output(X))
        np.testing.assert_allclose(pi.output(X), want, atol=ATOL, rtol=0)
        assert np.abs(pi.output(X) - step1).max() > 1e-4   # the swap changed the answer
        hs = pi.stats()["hot_swap"]
        assert (hs["swaps"], hs["current_checkpoint_step"]) == (1, 2)
        assert hs == {**jpi.stats()["hot_swap"], "last_poll_delay_s": None}
        assert pi.poll_checkpoint() is jpi.poll_checkpoint() is False

        # a torn newest commit: the manager falls back to step 2 — neither
        # package re-swaps it or downgrades
        torn = _commit(jnet, jcm, 3)
        tear_file(os.path.join(d, torn))
        assert pi.poll_checkpoint() is jpi.poll_checkpoint() is False
        assert pi.stats()["hot_swap"]["current_checkpoint_step"] == 2
        np.testing.assert_allclose(pi.output(X), want, atol=ATOL, rtol=0)
        _commit(jnet, jcm, 4)
        assert pi.poll_checkpoint() is jpi.poll_checkpoint() is True
        assert pi.stats()["hot_swap"]["current_checkpoint_step"] == 4
        np.testing.assert_allclose(pi.output(X), np.asarray(_jax_restored(d).output(X)),
                                   atol=ATOL, rtol=0)
    finally:
        pi.shutdown()
        jpi.shutdown()


def test_quantize_record_reapplied_on_every_swap(tmp_path):
    d = str(tmp_path / "store")
    jnet, jcm = _jax_net(seed=5), JaxCM(d, async_write=False)
    _commit(jnet, jcm, 1)
    rng = np.random.default_rng(3)
    jrec = jax_calibrate(jnet, [rng.random((8, 4)).astype(np.float32) for _ in range(2)])
    prec = CalibrationRecord.from_json(jrec.to_json())
    pcm = CheckpointManager(d, device="cpu")
    pi = ParallelInference(pcm.restore_latest(load_updater=False), quantize=prec,
                           device="cpu", checkpoint_manager=pcm)
    try:
        assert pi.quantized and is_quantized(pi.model)
        np.testing.assert_allclose(pi.output(X), np.asarray(
            jax_quantize(_jax_restored(d), jrec).output(X)), atol=ATOL, rtol=0)
        layers = list(pi.model.layers)
        _commit(jnet, jcm, 2)
        assert pi.poll_checkpoint()
        assert is_quantized(pi.model) and list(pi.model.layers) == layers
        np.testing.assert_allclose(pi.output(X), np.asarray(
            jax_quantize(_jax_restored(d), jrec).output(X)), atol=ATOL, rtol=0)
    finally:
        pi.shutdown()


def test_other_architecture_in_the_store_is_refused(tmp_path):
    d = str(tmp_path / "store")
    jcm = JaxCM(d, async_write=False)
    _commit(_jax_net(), jcm, 1)
    pcm = CheckpointManager(d, device="cpu")
    pi = ParallelInference(pcm.restore_latest(load_updater=False), device="cpu",
                           checkpoint_manager=pcm)
    try:
        before = pi.output(X)
        wide = _jax_net(hidden=24)
        for _ in range(3):  # a newer step than the served one
            wide.fit(_batch(7))
        jcm.save(wide)
        jcm.flush()
        with pytest.raises(RuntimeError, match="different structure"):
            pi.poll_checkpoint()
        np.testing.assert_array_equal(pi.output(X), before)
        assert pi.stats()["hot_swap"]["swaps"] == 0
    finally:
        pi.shutdown()


def test_requests_across_a_swap_each_see_one_whole_network(tmp_path):
    d = str(tmp_path / "store")
    jnet, jcm = _jax_net(seed=8), JaxCM(d, async_write=False)
    _commit(jnet, jcm, 1)
    pcm = CheckpointManager(d, device="cpu")
    pi = ParallelInference(pcm.restore_latest(load_updater=False), batch_limit=4,
                           device="cpu", checkpoint_manager=pcm)
    want1 = pi.output(X)
    _commit(jnet, jcm, 2)
    want2 = np.asarray(_jax_restored(d).output(X))
    answers, errors = [], []
    go = threading.Event()

    def client(i):
        go.wait(10)
        try:
            for _ in range(30):
                answers.append((i, pi.submit(X[i:i + 2]).get(timeout=30)))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    go.set()
    swapped = pi.poll_checkpoint()
    for t in threads:
        t.join(30)
    after = pi.output(X)
    pi.shutdown()
    assert swapped and not errors and len(answers) == 90
    for i, a in answers:
        old = np.allclose(a, want1[i:i + 2], atol=ATOL, rtol=0)
        new = np.allclose(a, want2[i:i + 2], atol=ATOL, rtol=0)
        assert old != new, "an answer that is neither network's whole answer"
    np.testing.assert_allclose(after, want2, atol=ATOL, rtol=0)


def test_latest_step_and_refresh_read_the_jax_journal(tmp_path):
    d = str(tmp_path / "store")
    pcm = CheckpointManager(d, device="cpu")
    jcm_reader = JaxCM(d)
    assert pcm.latest_step() is None is jcm_reader.latest_step()
    jnet, jcm = _jax_net(), JaxCM(d, async_write=False)
    _commit(jnet, jcm, 1)
    assert pcm.latest_step() is None       # not refreshed yet
    assert pcm.refresh() == jcm_reader.refresh() == 1
    assert pcm.latest_step() == jcm_reader.latest_step() == 1
    _commit(jnet, jcm, 2)
    pcm.refresh()
    jcm_reader.refresh()
    assert pcm.latest_step() == jcm_reader.latest_step() == 2
    assert pcm.last_refresh_error is None
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{torn")
    assert pcm.refresh() == jcm_reader.refresh() == 2      # keeps the known journal
    assert pcm.last_refresh_error is not None and jcm_reader.last_refresh_error is not None
    pi = ParallelInference(CheckpointManager(str(tmp_path / "other"), device="cpu")
                           .restore_latest(load_updater=False) or _port_net(),
                           device="cpu", checkpoint_manager=pcm)
    try:
        with pytest.raises(type(pcm.last_refresh_error)):
            pi.poll_checkpoint()
    finally:
        pi.shutdown()


def _port_net():
    from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    j = _jax_net()
    net = MultiLayerNetwork(conf_from_jax_json(j.conf.to_json()), device="cpu")
    net.params = params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                  for p in j.params], device="cpu")
    return net


def test_poll_backoff_warmup_and_learned_ladder_follow_jax():
    pi, jpi = ParallelInference(_port_net(), device="cpu"), JaxPI(_jax_net())
    try:
        for streak in (0, 1, 2, 3, 5, 9):
            assert pi._next_poll_delay(0.5, streak) == jpi._next_poll_delay(0.5, streak)
        assert pi.warmup(np.zeros((1, 4), np.float32)) == jpi.warmup(np.zeros((1, 4)))
        for rows in (1, 3, 9, 9, 9, 17, 2):
            pi.output(np.zeros((rows, 4), np.float32))
            jpi.output(np.zeros((rows, 4), np.float32))
        st, jst = pi.stats(), jpi.stats()
        for key in ("warmed_buckets", "bucket_dispatches", "unwarmed_dispatches",
                    "row_size", "bucket_policy"):
            assert st[key] == jst[key], key
        assert st["unwarmed_dispatches"] == 0
        assert repr(pi.learned_bucket_policy(3)) == repr(jpi.learned_bucket_policy(3))
        rows = [1, 3, 9, 9, 9, 17, 2, 30, 30, 4]
        from deeplearning4j_tpu_torch.perf.bucketing import BucketPolicy
        for k in (1, 2, 4, 8):
            assert repr(BucketPolicy.from_histogram(rows, k)) == repr(
                JaxBucketPolicy.from_histogram(rows, k))
        seq = ParallelInference(_port_net(), inference_mode="sequential", device="cpu")
        np.testing.assert_allclose(seq.submit(X).get(), pi.output(X), atol=0, rtol=0)
        assert seq.stats()["requests_served"] == 1
    finally:
        pi.shutdown()
        jpi.shutdown()
