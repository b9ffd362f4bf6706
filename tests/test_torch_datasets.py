"""The port's data tier on the CPU against the JAX package: every iterator's
batches bitwise, ``AsyncDataSetIterator``'s order and error propagation,
the fetchers over files the test writes (idx, gzipped idx, CIFAR binary,
EMNIST) and over the seeded synthetic sets, the normalizers (within 1e-6),
every record-reader mode, the native and Python CSV parses, shard files
written by one package and read by the other, ``CSVShardSource``,
``ShardedDataset`` epoch orders at world sizes 1, 2 and 4 with
``iter_from``, leases and the ledger over a ``LocalFSBackend``, and the
bucketing iterators.

Inputs come from numpy with fixed seeds. Every comparison is exact unless
it states a tolerance: both packages run the same numpy code on the host.
"""

import gzip
import os
import struct

import numpy as np
import pytest

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.datasets.fetchers as jfetch
import deeplearning4j_tpu.native as jnative
import deeplearning4j_tpu.perf.bucketing as jbuck
import deeplearning4j_tpu_torch.datasets as pds
import deeplearning4j_tpu_torch.datasets.fetchers as pfetch
import deeplearning4j_tpu_torch.native as pnative
import deeplearning4j_tpu_torch.perf.bucketing as pbuck
from deeplearning4j_tpu.checkpoint.storage import LocalFSBackend as JLocal
from deeplearning4j_tpu_torch.checkpoint.storage import LocalFSBackend as PLocal

FIELDS = ("features", "labels", "features_mask", "labels_mask")


def _arrays(ds):
    if hasattr(ds, "features_masks"):  # MultiDataSet
        return [ds.features, ds.labels, ds.features_masks, ds.labels_masks]
    return [getattr(ds, f) for f in FIELDS]


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _same_stream(js, ps):
    js, ps = list(js), list(ps)
    assert len(js) == len(ps) > 0
    for j, p in zip(js, ps):
        _same(_arrays(j), _arrays(p))


def _data(seed=0, n=23, d=5, k=3, masks=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    if not masks:
        return x, y, None, None
    return x, y, (rng.random(n) > 0.3).astype(np.float32), (rng.random(n) > 0.2).astype(
        np.float32)


def _ds(pkg, seed=0, **kw):
    return pkg.DataSet(*_data(seed, **kw))


# every iterator, built the same way in each package
ITERATORS = {
    "list": lambda m: m.ListDataSetIterator(_ds(m, masks=True), 5),
    "iris": lambda m: m.IrisDataSetIterator(batch=32, num_examples=150),
    "mnist": lambda m: m.MnistDataSetIterator(batch=64, num_examples=200, seed=3),
    "mnist_test": lambda m: m.MnistDataSetIterator(batch=50, num_examples=120, train=False),
    "cifar": lambda m: m.CifarDataSetIterator(batch=16, num_examples=40),
    "emnist": lambda m: m.EmnistDataSetIterator("letters", batch=16, num_examples=40),
    "svhn": lambda m: m.SvhnDataSetIterator(batch=16, num_examples=40),
    "tiny_imagenet": lambda m: m.TinyImageNetDataSetIterator(batch=8, num_examples=20),
    "lfw": lambda m: m.LFWDataSetIterator(batch=8, num_examples=20),
    "early_termination": lambda m: m.EarlyTerminationDataSetIterator(
        m.ListDataSetIterator(_ds(m), 4), 3),
    "existing": lambda m: m.ExistingDataSetIterator(_ds(m).split(6)),
    "iterator_rebatch": lambda m: m.IteratorDataSetIterator(
        [_ds(m, seed=1, n=7, masks=True), _ds(m, seed=2, n=11, masks=True)], 5),
    "sampling": lambda m: m.SamplingDataSetIterator(_ds(m, masks=True), 4, 10, seed=9),
    "multiple_epochs": lambda m: m.MultipleEpochsIterator(3, m.ListDataSetIterator(_ds(m), 8)),
    "async": lambda m: m.AsyncDataSetIterator(m.ListDataSetIterator(_ds(m, n=60), 7),
                                              queue_size=2),
    "list_multi": lambda m: m.ListMultiDataSetIterator(
        m.MultiDataSet([_data(3)[0], _data(4)[0]], [_data(5)[1]]), 6),
    "multi_adapter": lambda m: m.MultiDataSetIteratorAdapter(m.ListDataSetIterator(_ds(m), 9)),
    "joint_multi": lambda m: m.JointMultiDataSetIterator(
        m.ListDataSetIterator(_ds(m, seed=1), 6), m.ListDataSetIterator(_ds(m, seed=2), 6)),
    "async_multi": lambda m: m.AsyncMultiDataSetIterator(m.ListMultiDataSetIterator(
        m.MultiDataSet([_data(3)[0]], [_data(5)[1]]), 4)),
}


@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_iterator_batches_equal_jax(name, monkeypatch, tmp_path):
    """Bitwise the JAX package's batches, two passes (a sampling or sharded
    iterator draws anew each pass)."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))  # no cached corpus
    ji, pi = ITERATORS[name](jds), ITERATORS[name](pds)
    for _ in range(2):
        _same_stream(ji, pi)
    for meth in ("batch_size", "input_columns", "total_outcomes"):
        if hasattr(ji, meth):
            try:
                want = getattr(ji, meth)()
            except NotImplementedError:
                continue
            assert getattr(pi, meth)() == want


def test_async_iterator_propagates_the_worker_error():
    """The items before the failure arrive in order, then the worker's
    exception reaches the consumer, in both packages."""
    def source(m):
        def gen():
            for i in range(5):
                yield m.DataSet(np.full((2, 3), i, np.float32), np.eye(2, dtype=np.float32))
                if i == 2:
                    raise KeyError("shard 3 unreadable")
        return m.ExistingDataSetIterator(gen())

    for m in (jds, pds):
        got = []
        with pytest.raises(KeyError, match="shard 3 unreadable"):
            for ds in m.AsyncDataSetIterator(source(m), queue_size=1):
                got.append(float(ds.features[0, 0]))
        assert got == [0.0, 1.0, 2.0]


def _write_idx(path, images=None, labels=None):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        if images is not None:
            f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
            f.write(images.tobytes())
        else:
            f.write(struct.pack(">II", 2049, len(labels)))
            f.write(labels.tobytes())


@pytest.mark.parametrize("fmt", ["idx", "idx.gz", "cifar", "emnist"])
def test_fetchers_read_files_on_disk(fmt, monkeypatch, tmp_path):
    """Files in the reference's cache layouts under DL4J_TPU_DATA_DIR are
    read, not generated, and both packages return the same arrays."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (30, 784), dtype=np.uint8)
    labs = rng.integers(0, 10, 30).astype(np.uint8)
    if fmt.startswith("idx"):
        ext = ".gz" if fmt.endswith("gz") else ""
        os.makedirs(tmp_path / "mnist")
        _write_idx(str(tmp_path / "mnist" / f"train-images-idx3-ubyte{ext}"), imgs)
        _write_idx(str(tmp_path / "mnist" / f"train-labels-idx1-ubyte{ext}"), labels=labs)
        got = [f.mnist_data(25) for f in (jfetch, pfetch)]
        want_x = imgs[:25].astype(np.float32) / 255.0
    elif fmt == "cifar":
        base = tmp_path / "cifar10" / "cifar-10-batches-bin"
        os.makedirs(base)
        raw = rng.integers(0, 256, (12, 3073), dtype=np.uint8)
        raw[:, 0] = labs[:12]
        raw.tofile(base / "test_batch.bin")
        got = [f.cifar10_data(10, train=False) for f in (jfetch, pfetch)]
        want_x = (raw[:10, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                  .astype(np.float32) / 255.0)
        labs = raw[:, 0]
    else:
        os.makedirs(tmp_path / "emnist")
        letters = (labs % 26 + 1).astype(np.uint8)
        _write_idx(str(tmp_path / "emnist" / "emnist-letters-train-images-idx3-ubyte"), imgs)
        _write_idx(str(tmp_path / "emnist" / "emnist-letters-train-labels-idx1-ubyte"),
                   labels=letters)
        got = [f.emnist_data("letters", 25) for f in (jfetch, pfetch)]
        want_x = imgs[:25].astype(np.float32) / 255.0
        labs = letters - 1
    (jx, jy), (px, py) = got
    _same([jx, jy], [px, py])
    assert np.array_equal(px, want_x)
    assert np.array_equal(py.argmax(-1), labs[:len(py)])


@pytest.mark.parametrize("fetch", [
    lambda f: f.synthetic_mnist(50, seed=5), lambda f: f.synthetic_images(20, 16, 3, 7, 8),
    lambda f: f.iris_data(), lambda f: f.mnist_data(40, train=False, seed=2),
    lambda f: f.svhn_data(10), lambda f: f.tiny_imagenet_data(6), lambda f: f.lfw_data(6)],
    ids=["synthetic_mnist", "synthetic_images", "iris", "mnist", "svhn", "tiny_imagenet",
         "lfw"])
def test_generated_sets_equal_jax(fetch, monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    _same(list(fetch(jfetch)), list(fetch(pfetch)))


@pytest.mark.parametrize("kind", ["standardize", "standardize_labels", "minmax", "image",
                                  "combined"])
def test_normalizers_match_jax(kind):
    """Fitted statistics and transformed batches within 1e-6 (float32
    results of the same float64 statistics)."""
    rng = np.random.default_rng(6)

    def build(m):
        x = rng_x.copy()
        data = m.ListDataSetIterator(m.DataSet(x, y.copy()), 8)
        if kind.startswith("standardize"):
            n = m.NormalizerStandardize(fit_labels=kind.endswith("labels"))
            n.fit(data)
        elif kind == "minmax":
            n = m.NormalizerMinMaxScaler(-1.0, 1.0)
            n.fit(data)
        elif kind == "image":
            n = m.ImagePreProcessingScaler(0.0, 1.0)
        else:
            a = m.NormalizerMinMaxScaler()
            a.fit(data)
            n = m.CombinedPreProcessor(a, m.ImagePreProcessingScaler(-1.0, 1.0, 2.0))
        return n, data

    rng_x = (rng.random((30, 6)) * 255).astype(np.float32)
    y = rng.standard_normal((30, 2)).astype(np.float32)
    (jn, jd), (pn, pd) = build(jds), build(pds)
    for j, p in zip(jd.set_pre_processor(jn), pd.set_pre_processor(pn)):
        for f in ("features", "labels"):
            a, b = getattr(j, f), getattr(p, f)
            assert a.dtype == b.dtype
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    if kind.startswith("standardize"):
        x = rng_x[:4]
        np.testing.assert_allclose(pn.revert_features(pn.pre_process(
            pds.DataSet(x, y[:4])).features), jn.revert_features(jn.pre_process(
                jds.DataSet(x, y[:4])).features), rtol=0, atol=1e-6)


CSV = "\n".join(",".join(f"{v:.3f}" for v in row) + f",{c}"
                for row, c in zip(np.random.default_rng(7).random((17, 4)),
                                  np.random.default_rng(8).integers(0, 3, 17)))


@pytest.mark.parametrize("mode", ["label_index", "regression", "label_range", "no_labels",
                                  "string_labels", "max_batches", "collection", "header"])
def test_record_reader_modes_match_jax(mode):
    def it(m):
        src, kw = CSV, {}
        if mode == "label_index":
            kw = dict(label_index=4, num_possible_labels=3)
        elif mode == "regression":
            kw = dict(label_index=0, regression=True)
        elif mode == "label_range":
            kw = dict(regression=True, label_index_from=1, label_index_to=2)
        elif mode == "string_labels":
            src = "\n".join(line.rsplit(",", 1)[0] + "," + "abc"[int(line[-1])]
                            for line in CSV.split("\n"))
            kw = dict(label_index=4, num_possible_labels=3)
        elif mode == "max_batches":
            kw = dict(label_index=4, num_possible_labels=3, max_num_batches=2)
        elif mode == "header":
            return m.RecordReaderDataSetIterator(
                m.CSVRecordReader("a,b,c,d,e\n" + CSV, skip_lines=1), 5, label_index=4,
                num_possible_labels=3)
        if mode == "collection":
            rows = [[float(v) for v in line.split(",")] for line in CSV.split("\n")]
            return m.RecordReaderDataSetIterator(m.CollectionRecordReader(rows), 6,
                                                 label_index=4, num_possible_labels=3)
        return m.RecordReaderDataSetIterator(m.CSVRecordReader(src), 5, **kw)

    _same_stream(it(jds), it(pds))


@pytest.mark.parametrize("mode", ["classify", "regression", "no_labels"])
def test_sequence_record_reader_matches_jax(mode):
    """Sequences of uneven length padded to the longest, with masks."""
    rng = np.random.default_rng(9)
    seqs = ["\n".join(f"{rng.random():.3f},{rng.random():.3f},{rng.integers(0, 2)}"
                      for _ in range(t)) for t in (3, 5, 4, 2, 5)]
    kw = {"classify": dict(label_index=2, num_possible_labels=2),
          "regression": dict(label_index=2, regression=True), "no_labels": {}}[mode]
    _same_stream(*(m.SequenceRecordReaderDataSetIterator(m.CSVSequenceRecordReader(seqs), 2,
                                                         **kw) for m in (jds, pds)))


@pytest.mark.parametrize("text", ["1,2,3\n4,5,6\n", "0.5;-1e3;7\n2;3;4\n", "1,x\n2,3\n",
                                  "1,2\n3\n"], ids=["plain", "semicolon", "string", "ragged"])
def test_csv_parses_native_and_python_equal_jax(text, monkeypatch):
    """The native parse equals the JAX package's; a string or ragged field
    declines (None) in both, counted as a Python parse; with no compiler the
    port's parse declines and its reader's rows still equal the JAX
    package's."""
    delim = ";" if ";" in text else ","
    data = text.encode()
    want = jnative.parse_csv_numeric(data, delim)
    n0, p0 = pnative.parses_native, pnative.parses_python
    got = pnative.parse_csv_numeric(data, delim)
    _same(want, got)
    assert (pnative.parses_native - n0, pnative.parses_python - p0) == (
        (0, 1) if want is None else (1, 0))
    if want is None:
        return
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_tried", True)
    assert pnative.parse_csv_numeric(data, delim) is None
    rows = list(pds.CSVRecordReader(text, delimiter=delim))
    assert np.array_equal(np.asarray(rows, np.float32), want)
    _same_stream(jds.RecordReaderDataSetIterator(jds.CSVRecordReader(text, delimiter=delim),
                                                 1),
                 pds.RecordReaderDataSetIterator(pds.CSVRecordReader(text, delimiter=delim),
                                                 1))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_written_by_one_package_read_by_the_other(writer, tmp_path):
    x, y, fm, lm = _data(10, n=37, masks=True)
    w, r = (jds, pds) if writer == "jax" else (pds, jds)
    wb = (JLocal if writer == "jax" else PLocal)(str(tmp_path))
    rb = (PLocal if writer == "jax" else JLocal)(str(tmp_path))
    w.write_shards(wb, "c/", x, y, records_per_shard=10, features_mask=fm, labels_mask=lm)
    src = r.ShardFileSource(rb, "c/")
    assert src.shard_sizes == [10, 10, 10, 7]
    blocks = [src.load_shard(i) for i in range(4)]
    for f, a in zip(FIELDS, (x, y, fm, lm)):
        assert np.array_equal(np.concatenate([b[f] for b in blocks]), a)


def test_csv_shard_source_matches_jax(tmp_path):
    for i, part in enumerate((CSV.split("\n")[:9], CSV.split("\n")[9:])):
        (tmp_path / f"part-{i}.csv").write_text("\n".join(part) + "\n")
    srcs = [m.CSVShardSource(b(str(tmp_path)), "part-", label_index=4, num_possible_labels=3)
            for m, b in ((jds, JLocal), (pds, PLocal))]
    assert srcs[0].shard_sizes == srcs[1].shard_sizes == [9, 8]
    for i in range(2):
        _same([srcs[0].load_shard(i)[f] for f in FIELDS],
              [srcs[1].load_shard(i)[f] for f in FIELDS])
    _same_stream(*(m.ShardedDataset(source=s, batch_size=4, seed=3).reader()
                   for m, s in zip((jds, pds), srcs)))


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("source", [False, True], ids=["arrays", "shard_files"])
def test_sharded_epoch_orders_bitwise_at_every_world_size(world, source, tmp_path):
    """Every rank's batches equal the JAX package's in epochs 0-2, also
    after a seek (iter_from) and with the epoch bound to a counter; the
    ranks together cover each global batch of the single-worker run."""
    x, y, _, _ = _data(11, n=64, d=3)

    def dataset(m, backend):
        if source:
            src = m.write_shards(backend(str(tmp_path / m.__name__)), "s/", x, y,
                                 records_per_shard=12)
            return m.ShardedDataset(source=src, batch_size=8, seed=4)
        return m.ShardedDataset(x, y, batch_size=8, seed=4)

    jd, pd = dataset(jds, JLocal), dataset(pds, PLocal)
    for epoch in range(3):
        assert np.array_equal(jd.epoch_order(epoch), pd.epoch_order(epoch))
    for rank in range(world):
        jr, pr = jd.reader(rank, world), pd.reader(rank, world)
        for _ in range(2):  # epochs 0 and 1, auto-advanced
            _same_stream(jr, pr)
        epoch = [2]
        jr.bind_epoch(lambda: epoch[0])
        pr.bind_epoch(lambda: epoch[0])
        _same_stream(jr.iter_from(3), pr.iter_from(3))
        assert len(list(pr.iter_from(3))) == 64 // 8 - 3
    whole = [d.features for d in pd.reader()]
    parts = [list(pd.reader(r, world)) for r in range(world)]
    for b, full in enumerate(whole):
        assert np.array_equal(np.concatenate([parts[r][b].features for r in range(world)]), full)


def test_leases_and_ledger_over_a_local_backend(tmp_path):
    """Two port ranks consume one epoch over one LocalFSBackend with leases
    and the ledger on; both packages' reconcile_ledger read the same clean
    record order, the JAX single-worker epoch order; a later-generation
    lease fences a stale reader in the port as in the JAX package."""
    x, y, _, _ = _data(12, n=48, d=2)
    store = PLocal(str(tmp_path))
    pd = pds.ShardedDataset(x, y, batch_size=8, seed=6, store=store, ledger=True,
                            lease_batches=2)
    readers = [pd.reader(r, 2, worker_id=f"w{r}") for r in range(2)]
    for r in readers:
        assert len(list(r)) == 6
        r.release_all()
    jrep = jds.reconcile_ledger(JLocal(str(tmp_path)), 8)
    prep = pds.reconcile_ledger(store, 8)
    assert jrep.clean and prep.clean
    assert jrep.epochs == prep.epochs
    assert prep.epochs[0] == [int(i) for i in
                              jds.ShardedDataset(x, y, batch_size=8, seed=6).epoch_order(0)]
    for m, backend in ((jds, JLocal), (pds, PLocal)):
        d = m.ShardedDataset(x, y, batch_size=8, seed=6,
                             store=backend(str(tmp_path / ("f" + m.__name__))))
        newer = d.reader(0, 1, worker_id="new", generation=2)
        it = iter(newer)
        next(it)  # holds a generation-2 lease on chunk 0
        with pytest.raises(m.StaleDataLeaseError):
            next(iter(d.reader(0, 1, worker_id="old", generation=1)))
        it.close()


@pytest.mark.parametrize("case", ["pad_dataset", "pad_sequence", "pad_multi", "bucket_iter",
                                  "bucket_multi", "rebatch"])
def test_bucketing_matches_jax(case):
    def build(m, b):
        if case == "pad_dataset":
            return [b.pad_dataset(_ds(m, n=5, masks=True), 8),
                    b.pad_dataset(_ds(m, n=8), 8, ensure_lmask=True)]
        if case == "pad_sequence":
            rng = np.random.default_rng(13)
            x = rng.standard_normal((3, 4, 2)).astype(np.float32)
            y = rng.standard_normal((3, 4, 5)).astype(np.float32)
            return [b.pad_dataset(m.DataSet(x, y, features_mask=np.ones((3, 4), np.float32)),
                                  8),
                    b.pad_dataset(m.DataSet(x, y), 4, ensure_lmask=True)]
        if case == "pad_multi":
            x, y, fm, _ = _data(14, n=5, masks=True)
            return [b.pad_multi_dataset(m.MultiDataSet([x, x], [y, y], [fm, None], None), 8)]
        if case == "bucket_multi":
            return list(b.BucketPadDataSetIterator(m.ListMultiDataSetIterator(
                m.MultiDataSet([_data(3)[0]], [_data(5)[1]]), 10), b.BucketPolicy(floor=4)))
        base = m.ListDataSetIterator(_ds(m, n=23, masks=True), 6)
        if case == "bucket_iter":
            return list(b.BucketPadDataSetIterator(base, b.BucketPolicy(floor=4)))
        return list(b.RebatchDataSetIterator(m.IteratorDataSetIterator(base, 4), 7))

    _same_stream(build(jds, jbuck), build(pds, pbuck))


def test_streaming_index_build_over_a_sharded_dataset():
    """A ShardedDataset feeds the two-pass streaming PQ build (a fresh
    reader a pass, so both passes see epoch 0's order): the index equals
    the one built from the same rows in that order."""
    import deeplearning4j_tpu_torch.retrieval as pr
    rng = np.random.default_rng(15)
    v = rng.standard_normal((240, 8)).astype(np.float32)
    ds = pds.ShardedDataset(v, None, batch_size=16, seed=2)
    rows = v[ds.epoch_order(0)]
    got = pr.build_index_streaming(ds, kind="pq", M=2, ksub=16, seed=1, train_size=240,
                                   device="cpu")
    want = pr.build_index_streaming([rows[:100], rows[100:]], kind="pq", M=2, ksub=16,
                                    seed=1, train_size=240, device="cpu")
    q = rng.standard_normal((5, 8)).astype(np.float32)
    for a, b in zip(got.search(q, 4), want.search(q, 4)):
        assert np.array_equal(a, b)
