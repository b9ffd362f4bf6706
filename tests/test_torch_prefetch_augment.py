"""The port's on-device augmentation, device prefetch and bucketed fit on
the CPU, against the JAX package where it has the same function:

- ``ImageAugmentation.apply_with`` fed JAX's draws (``jax.random.split``,
  ``randint``, ``bernoulli`` on one key) equals the JAX ``apply`` bitwise
  in float32, crop, flip and normalize alone and together;
- one training step of a small conv net with augmentation, JAX's draws fed
  to the port, within the training slice's step tolerance (loss rtol 1e-5,
  parameters rtol 1e-5 / atol 1e-6: torch and XLA sum convolutions in other
  orders);
- ``fit(prefetch=True)`` bitwise ``fit(prefetch=False)`` on both networks;
- ``fit(bucket_policy=True)`` and ``fit_fused(bucket_policy=True)`` with a
  ragged last batch against the JAX ``fit`` (the same step tolerance);
- a zip carrying an augmentation read both ways;
- crash-exact resume over a ``ShardedReader`` with augmentation and
  prefetch on, bitwise, the reader seeking (the resumed run loads only the
  shards of the batches it has not consumed).

Inputs come from numpy with fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets.augment import ImageAugmentation as JAug
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf.convolutional import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.conf.network import Builder as JBuilder
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.utils import serialization as jser

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, FaultInjector, SimulatedCrash
from deeplearning4j_tpu_torch.datasets import (DataSet, ShardedDataset, ShardFileSource,
                                               write_shards)
from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.models import ResNet50
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves
from deeplearning4j_tpu_torch.perf.prefetch import DevicePrefetchIterator
from deeplearning4j_tpu_torch.utils import serialization as pser

SIDE, CLASSES = 8, 3
AUGS = {
    "crop": dict(crop_padding=2),
    "flip": dict(flip_prob=0.5),
    "normalize": dict(mean=(0.1, -0.2, 0.3), std=(1.5, 0.5, 2.0)),
    "all": dict(crop_padding=3, flip_prob=0.5, mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.4)),
}


@pytest.fixture(autouse=True)
def _native_cpu_convolutions():
    """oneDNN's multithreaded CPU convolution backward crashes in a process
    that has run XLA:CPU programs (see tests/test_torch_training.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _jax_draws(aug: JAug, key, n):
    """The draws JAX's ``apply`` takes from ``key``, as numpy arrays."""
    k_oy, k_ox, k_flip = jax.random.split(key, 3)
    hi = 2 * aug.crop_padding + 1
    oy = ox = flip = None
    if aug.crop_padding:
        oy = np.asarray(jax.random.randint(k_oy, (n,), 0, hi))
        ox = np.asarray(jax.random.randint(k_ox, (n,), 0, hi))
    if aug.flip_prob:
        flip = np.asarray(jax.random.bernoulli(k_flip, aug.flip_prob, (n,)))
    return oy, ox, flip


def _images(seed, n=6, side=SIDE):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(AUGS))
def test_apply_with_jax_draws_equals_jax_apply(name):
    """Bitwise in float32; the port's own draws are in range and on the
    batch's device, and to_dict / from_dict equal the JAX package's."""
    kw = AUGS[name]
    jaug, paug = JAug(**kw), ImageAugmentation(**kw)
    assert paug.to_dict() == jaug.to_dict()
    assert ImageAugmentation.from_dict(jaug.to_dict()) == paug
    x = _images(1, n=16)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.apply(jnp.asarray(x), key))
    oy, ox, flip = _jax_draws(jaug, key, len(x))
    got = paug.apply_with(torch.from_numpy(x), *(None if d is None else torch.from_numpy(d)
                                                   for d in (oy, ox, flip)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(3)
    oy, ox, flip = paug.draws(torch.from_numpy(x), gen)
    if paug.crop_padding:
        assert 0 <= int(oy.min()) and int(ox.max()) <= 2 * paug.crop_padding
    assert paug.apply(torch.from_numpy(x), gen).shape == x.shape


class _Fed:
    """An augmentation that applies fixed draws (JAX's) in the port's step."""

    def __init__(self, aug, draws):
        self.aug, self.draws = aug, draws

    def apply(self, x, generator):
        return self.aug.apply_with(x, *(None if d is None else torch.from_numpy(d)
                                         for d in self.draws))


def _jax_conv_conf(updater=None, seed=3):
    return (JBuilder().seed(seed).updater(updater or jupd.Sgd(learning_rate=0.1))
            .weight_init("xavier").list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(JOutput(n_out=CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(SIDE, SIDE, 3)).build())


def _host(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _pair(updater=None):
    jnet = JMLN(_jax_conv_conf(updater)).init()
    pnet = MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    pnet.set_params(params_from_jax(_host(jnet.params), device="cpu"))
    return jnet, pnet


def _labels(seed, n):
    return np.eye(CLASSES, dtype=np.float32)[np.random.default_rng(seed).integers(0, CLASSES, n)]


def _assert_params(pnet, jnet, rtol=1e-5, atol=1e-6):
    for p, j in zip(pnet.params, _host(jnet.params)):
        for k in j:
            np.testing.assert_allclose(p[k].numpy(), j[k], rtol=rtol, atol=atol, err_msg=k)


def test_training_step_with_augmentation_fed_jax_draws_matches_jax():
    kw = AUGS["all"]
    jnet, pnet = _pair()
    jnet.set_augmentation(JAug(**kw))
    x, y = _images(2), _labels(2, 6)
    _, k = jax.random.split(jnet._rng)   # the step key fit splits off
    _, ak = jax.random.split(k)          # the augmentation's split of it
    pnet.set_augmentation(_Fed(ImageAugmentation(**kw), _jax_draws(JAug(**kw), ak, 6)))
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.score() == pytest.approx(float(jnet._score), rel=1e-5)
    _assert_params(pnet, jnet)
    # the augmentation changed the step: without it the parameters differ
    _, plain = _pair()
    plain.fit(DataSet(x, y))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(plain.params),
                                                     tree_leaves(pnet.params)))


def _graph(seed=4):
    conf = dataclasses.replace(ResNet50(num_classes=CLASSES, input_shape=(SIDE, SIDE, 3))
                               .conf(), seed=seed)
    return ComputationGraph(conf, device="cpu").init()


def _mln(seed=3):
    return MultiLayerNetwork(conf_from_jax_json(_jax_conv_conf(seed=seed).to_json()),
                             device="cpu").init()


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_fit_prefetch_is_bitwise_fit_without(kind):
    """Prefetch changes no math: the same epochs with and without it end
    bitwise equal (augmentation on, so its generator's order counts too)."""
    batches = [DataSet(_images(s, n=4), _labels(s, 4)) for s in range(3)]
    nets = []
    for prefetch in (False, True):
        net = _mln() if kind == "multilayer" else _graph()
        net.set_augmentation(ImageAugmentation(crop_padding=1, flip_prob=0.5))
        net.fit(batches, num_epochs=2, prefetch=prefetch)
        nets.append(net)
    for a, b in zip(tree_leaves([nets[0].params, nets[0].state]),
                    tree_leaves([nets[1].params, nets[1].state])):
        assert torch.equal(a, b)
    assert nets[0].iteration == nets[1].iteration == 6


def test_prefetch_iterator_places_batches_and_passes_seek_through():
    x, y = _images(5, n=16), _labels(5, 16)
    ds = ShardedDataset(x, y, batch_size=4, seed=1)
    it = DevicePrefetchIterator(ds.reader(), device="cpu", lookahead=2)
    got = list(it)
    assert len(got) == 4 and all(isinstance(b.features, torch.Tensor) for b in got)
    assert it.batches_prefetched == 4 and it.batches_passed_through == 0
    epoch = [0]
    assert it.bind_epoch(lambda: epoch[0]) is it
    want = list(ds.reader().bind_epoch(lambda: 0).iter_from(2))
    seek = list(it.iter_from(2))
    assert len(seek) == 2
    for a, b in zip(seek, want):
        assert np.array_equal(a.features.numpy(), b.features)
    assert list(DevicePrefetchIterator(got, device="cpu", place_fn=lambda d: d)) == got
    with pytest.raises(NotImplementedError, match="A6"):
        DevicePrefetchIterator(got, device="cpu", mesh=object())


@pytest.mark.parametrize("form", ["fit", "fit_fused"])
def test_bucketed_fit_matches_jax(form):
    """A ragged last batch pads to the bucket, its rows masked out of the
    loss: the port's parameters after the epoch match the JAX package's."""
    jnet, pnet = _pair(jupd.Adam(learning_rate=1e-2))
    x, y = _images(7, n=20), _labels(7, 20)
    jb = JDataSet(x, y).split(8)
    pb = DataSet(x, y).split(8)
    if form == "fit":
        jnet.fit(jb, bucket_policy=True)
        pnet.fit(pb, bucket_policy=True)
    else:
        jnet.fit_fused(jb, bucket_policy=True)
        pnet.fit_fused(pb, bucket_policy=True)
    assert pnet.iteration == jnet.iteration == 3
    assert pnet.score() == pytest.approx(float(jnet._score), rel=1e-5)
    _assert_params(pnet, jnet)


def test_graph_bucketed_fit_trains_the_padded_batch_like_the_unpadded():
    """A ragged batch padded and masked scores like the batch itself (no
    batch norm in the way: the conv net's graph form)."""
    from deeplearning4j_tpu_torch.perf.bucketing import pad_multi_dataset
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    net = _mln()
    x, y = _images(8, n=5), _labels(8, 5)
    padded = pad_multi_dataset(MultiDataSet([x], [y]), 8)
    assert padded.features[0].shape[0] == 8 and padded.labels_masks[0].sum() == 5
    g = _graph()
    g.fit(DataSet(x, y), bucket_policy=True)
    assert g.iteration == 1 and np.isfinite(g.score())
    net.fit(DataSet(x, y), bucket_policy=True)
    ref = _mln()
    ref.fit(DataSet(x, y))
    assert net.score() == pytest.approx(ref.score(), rel=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_zip_with_augmentation_read_both_ways(writer, tmp_path):
    kw = AUGS["all"]
    path = str(tmp_path / "m.zip")
    if writer == "jax":
        jnet, _ = _pair()
        jnet.set_augmentation(JAug(**kw))
        jser.write_model(jnet, path)
        got = pser.restore(path, device="cpu")
        assert got.augmentation == ImageAugmentation(**kw)
    else:
        pnet = _mln().set_augmentation(ImageAugmentation(**kw))
        pser.write_model(pnet, path)
        assert jser.restore(path).augmentation == JAug(**kw)
        assert pser.restore(path, device="cpu").augmentation == ImageAugmentation(**kw)


def _shard_corpus(tmp_path, n=48, side=SIDE):
    x = (_images(9, n=n, side=side) * 40 + 128).clip(0, 255).astype(np.uint8)
    write_shards(str(tmp_path / "data"), "c/", x, _labels(9, n), records_per_shard=8)
    return ShardFileSource(str(tmp_path / "data"), "c/")


def _reader(src):
    from deeplearning4j_tpu_torch.datasets import ImagePreProcessingScaler
    return ShardedDataset(source=src, batch_size=8, seed=2).reader().set_pre_processor(
        ImagePreProcessingScaler())


def test_crash_exact_resume_over_a_sharded_reader_with_augmentation(tmp_path):
    """Checkpoint every step, crash at step 6 of 12 (2 epochs of 6), restore,
    fit on: bitwise the uninterrupted run, augmentation generator included;
    the resumed epoch seeks past the 5 consumed batches, loading only the
    shard of its one remaining batch."""
    aug = ImageAugmentation(crop_padding=2, flip_prob=0.5)

    def net():
        return _mln().set_augmentation(aug)

    ref = net()
    ref.fit(_reader(_shard_corpus(tmp_path)), num_epochs=2, prefetch=True)

    cm = CheckpointManager(str(tmp_path / "ck"), save_every_n_steps=1, device="cpu")
    crashed = net().set_listeners(FaultInjector(kill_at_step=6))
    with pytest.raises(SimulatedCrash):
        crashed.fit(_reader(_shard_corpus(tmp_path)), num_epochs=2, prefetch=True,
                    checkpoint_manager=cm)
    cm.close()
    cm2 = CheckpointManager(str(tmp_path / "ck"), save_every_n_steps=1, device="cpu")
    resumed = cm2.restore_latest()
    rs = resumed._resume_state
    assert (rs.step, rs.epoch, rs.batch_in_epoch) == (5, 0, 5)
    assert resumed.augmentation == aug
    src = _shard_corpus(tmp_path)
    loads_at_epoch_end = []

    class Loads:
        def iteration_done(self, *a):
            pass

        def on_epoch_start(self, net):
            pass

        def on_epoch_end(self, net):
            loads_at_epoch_end.append(src.loads)

    resumed.set_listeners(Loads())
    resumed.fit(_reader(src), num_epochs=2, prefetch=True, checkpoint_manager=cm2)
    cm2.close()
    # the rest of epoch 0 after the seek is 1 batch: 1 shard read (a replay
    # would read the 5 consumed batches' shards too)
    assert loads_at_epoch_end[0] == 1
    for a, b in zip(tree_leaves([ref.params, ref.opt_state]),
                    tree_leaves([resumed.params, resumed.opt_state])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert (ref.iteration, ref.epoch) == (resumed.iteration, resumed.epoch) == (12, 2)
    assert torch.equal(ref._aug_gen.get_state(), resumed._aug_gen.get_state())
    assert torch.equal(ref._gen.get_state(), resumed._gen.get_state())
