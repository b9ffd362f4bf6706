"""DataSet iterators (counterpart of ``deeplearning4j_tpu/datasets/iterators.py``;
reference ND4J ``DataSetIterator``, deeplearning4j-core/.../datasets/
iterator/impl/ and AsyncDataSetIterator.java).

Iterators are plain Python iterables of :class:`DataSet` with ``reset()``,
on the host: batches hold numpy arrays, and the network moves each to its
device when it trains on it. Every iterator yields the JAX package's
batches for the same arguments, bitwise (the same numpy draws in the same
order).

``AsyncDataSetIterator`` prefetches on a background thread, so host ETL
overlaps the step (the reference's prefetch thread around fit). The thread
touches no CUDA: the device half, staging batch N+1 onto the card while
step N runs, is :class:`~deeplearning4j_tpu_torch.perf.prefetch.
DevicePrefetchIterator` (re-exported here lazily), which runs on the
consumer's thread. The two compose, Async innermost::

    it = DevicePrefetchIterator(AsyncDataSetIterator(raw_iterator), device=dev)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import iris_data, mnist_data


class DataSetIterator:
    """Base iterator (parity: org.nd4j.linalg.dataset.api.iterator.DataSetIterator).

    ``set_pre_processor`` attaches a ``DataSet -> DataSet`` callable applied
    to every emitted batch (reference DataSetIterator.setPreProcessor)."""

    pre_processor = None

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        gen = self._generate()
        if self.pre_processor is None:
            return gen
        return (self.pre_processor(ds) for ds in gen)

    def set_pre_processor(self, pre_processor):
        self.pre_processor = pre_processor
        return self

    def _generate(self):
        raise NotImplementedError

    def reset(self):
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    # optional metadata used by networks for shape checks
    def input_columns(self) -> Optional[int]:
        return None

    def total_outcomes(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Iterate over a pre-split list of DataSets (parity:
    org.nd4j.linalg.dataset.api.iterator.impl ListDataSetIterator)."""

    def __init__(self, data, batch: Optional[int] = None):
        if isinstance(data, DataSet):
            data = data.split(batch or data.num_examples())
        self._data: List[DataSet] = list(data)
        self._batch = batch or (self._data[0].num_examples() if self._data else 0)

    def _generate(self):
        yield from self._data

    def batch_size(self):
        return self._batch

    def input_columns(self):
        f = self._data[0].features
        return int(np.prod(f.shape[1:]))

    def total_outcomes(self):
        return int(self._data[0].labels.shape[-1])


class IrisDataSetIterator(ListDataSetIterator):
    """Iris fixture iterator (reference
    deeplearning4j-core/.../datasets/iterator/impl/IrisDataSetIterator.java).
    Data embedded (150 examples, 4 features, 3 one-hot classes), normalized."""

    def __init__(self, batch: int = 150, num_examples: int = 150, shuffle_seed: Optional[int] = 42):
        x, y = iris_data()
        if shuffle_seed is not None:
            rng = np.random.default_rng(shuffle_seed)
            idx = rng.permutation(len(x))
            x, y = x[idx], y[idx]
        x = x[:num_examples]
        y = y[:num_examples]
        super().__init__(DataSet(x, y), batch)


class MnistDataSetIterator(ListDataSetIterator):
    """MNIST iterator (reference
    deeplearning4j-core/.../datasets/iterator/impl/MnistDataSetIterator.java +
    fetchers/MnistDataFetcher.java).

    Features are flat (batch, 784) float32 in [0,1] like the reference's
    binarize=false path. In zero-egress environments (no download), a
    deterministic synthetic MNIST-shaped dataset is generated instead
    (class-conditional patterns + noise) so training/tests remain meaningful.
    """

    def __init__(self, batch: int = 128, num_examples: int = 60000, train: bool = True,
                 seed: int = 123):
        x, y = mnist_data(num_examples, train=train, seed=seed)
        super().__init__(DataSet(x, y), batch)

    def input_columns(self):
        return 784

    def total_outcomes(self):
        return 10


def _async_generate(base, queue_size, end_sentinel):
    """Shared producer/consumer core for the async prefetch iterators.

    The producer checks a stop flag around every blocking put so an
    early-exiting consumer (break / EarlyTermination wrapper) releases the
    thread instead of leaving it blocked on a full queue holding the base
    iterator mid-stream."""
    q: "queue.Queue" = queue.Queue(maxsize=queue_size)
    stop = threading.Event()
    err = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in base:
                if not _put(item):
                    return
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            _put(end_sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end_sentinel:
                break
            yield item
    finally:
        stop.set()
        t.join()
    if err:
        raise err[0]


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference AsyncDataSetIterator.java).

    The worker thread only iterates the base (host work); a small bounded
    queue keeps memory in check. An exception in the worker reaches the
    consumer at the point of the stream where it was raised.
    """

    _END = object()

    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        self._base = base
        self._queue_size = queue_size

    def reset(self):
        if hasattr(self._base, "reset"):
            self._base.reset()

    def _generate(self):
        yield from _async_generate(self._base, self._queue_size, self._END)

    def batch_size(self):
        return self._base.batch_size()

    def input_columns(self):
        return self._base.input_columns()

    def total_outcomes(self):
        return self._base.total_outcomes()

    # seekable/epoch-aware base (datasets/sharded.py ShardedReader):
    # forward the resume/seek surface so exact-step resume still seeks
    # without materializing when the reader is wrapped for prefetch.
    # Via __getattr__ (not plain methods) so hasattr() on the wrapper
    # reflects whether the BASE actually supports seeking.
    def __getattr__(self, name):
        if name == "bind_epoch":
            base_bind = getattr(self._base, name)  # AttributeError if not

            def bind_epoch(provider):
                base_bind(provider)
                return self
            return bind_epoch
        if name == "iter_from":
            base_iter_from = getattr(self._base, name)

            def iter_from(start_batch):
                gen = _async_generate(base_iter_from(start_batch),
                                      self._queue_size, self._END)
                # a pre_processor set on THIS wrapper must apply on the
                # seek path exactly as __iter__ applies it
                if self.pre_processor is None:
                    return gen
                return (self.pre_processor(ds) for ds in gen)
            return iter_from
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Cap the number of minibatches (reference
    deeplearning4j-nn/.../datasets/iterator/EarlyTerminationDataSetIterator.java)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self._base = base
        self._max = max_batches

    def reset(self):
        self._base.reset()

    def _generate(self):
        for i, ds in enumerate(self._base):
            if i >= self._max:
                break
            yield ds

    def batch_size(self):
        return self._base.batch_size()

    def input_columns(self):
        return self._base.input_columns()

    def total_outcomes(self):
        return self._base.total_outcomes()


# ------------------------------------------------------------- image corpora
class CifarDataSetIterator(ListDataSetIterator):
    """CIFAR-10 NHWC (reference datasets/iterator/impl/CifarDataSetIterator.java;
    real data when cached locally, see fetchers.cifar10_data)."""

    def __init__(self, batch: int = 128, num_examples: int = 50000,
                 train: bool = True, seed: int = 321):
        from deeplearning4j_tpu_torch.datasets.fetchers import cifar10_data
        x, y = cifar10_data(num_examples, train=train, seed=seed)
        super().__init__(DataSet(x, y), batch)

    def total_outcomes(self):
        return 10


class EmnistDataSetIterator(ListDataSetIterator):
    """EMNIST splits (reference datasets/iterator/impl/EmnistDataSetIterator.java:53
    — COMPLETE/MERGE/BALANCED/LETTERS/DIGITS/MNIST sets)."""

    def __init__(self, split: str = "balanced", batch: int = 128,
                 num_examples: int = 10000, train: bool = True, seed: int = 555):
        from deeplearning4j_tpu_torch.datasets.fetchers import emnist_data, emnist_num_classes
        x, y = emnist_data(split, num_examples, train=train, seed=seed)
        self.split = split
        self._classes = emnist_num_classes(split)
        super().__init__(DataSet(x, y), batch)

    @staticmethod
    def num_labels(split: str) -> int:
        from deeplearning4j_tpu_torch.datasets.fetchers import emnist_num_classes
        return emnist_num_classes(split)

    def input_columns(self):
        return 784

    def total_outcomes(self):
        return self._classes


class SvhnDataSetIterator(ListDataSetIterator):
    """SVHN cropped digits (reference datasets/fetchers/SvhnDataFetcher.java)."""

    def __init__(self, batch: int = 128, num_examples: int = 10000,
                 train: bool = True, seed: int = 777):
        from deeplearning4j_tpu_torch.datasets.fetchers import svhn_data
        x, y = svhn_data(num_examples, train=train, seed=seed)
        super().__init__(DataSet(x, y), batch)

    def total_outcomes(self):
        return 10


class TinyImageNetDataSetIterator(ListDataSetIterator):
    """TinyImageNet 64x64x3, 200 classes (reference TinyImageNetFetcher.java)."""

    def __init__(self, batch: int = 128, num_examples: int = 5000,
                 train: bool = True, seed: int = 999):
        from deeplearning4j_tpu_torch.datasets.fetchers import tiny_imagenet_data
        x, y = tiny_imagenet_data(num_examples, train=train, seed=seed)
        super().__init__(DataSet(x, y), batch)

    def total_outcomes(self):
        return 200


class LFWDataSetIterator(ListDataSetIterator):
    """LFW faces (reference datasets/iterator/impl/LFWDataSetIterator.java)."""

    def __init__(self, batch: int = 64, num_examples: int = 1000,
                 train: bool = True, seed: int = 1111):
        from deeplearning4j_tpu_torch.datasets.fetchers import lfw_data
        x, y = lfw_data(num_examples, train=train, seed=seed)
        self._classes = y.shape[1]
        super().__init__(DataSet(x, y), batch)

    def total_outcomes(self):
        return self._classes


# --------------------------------------------------- more generic adapters
class ExistingDataSetIterator(DataSetIterator):
    """Wrap any iterable of DataSets (reference ExistingDataSetIterator.java)."""

    def __init__(self, iterable):
        self._iterable = iterable

    def _generate(self):
        yield from self._iterable

    def reset(self):
        if hasattr(self._iterable, "reset"):
            self._iterable.reset()


class IteratorDataSetIterator(DataSetIterator):
    """Re-batch a stream of (possibly ragged) DataSets to a fixed minibatch
    size (reference IteratorDataSetIterator.java)."""

    def __init__(self, base, batch: int):
        self._base = base
        self._batch = batch

    def reset(self):
        if hasattr(self._base, "reset"):
            self._base.reset()

    def batch_size(self):
        return self._batch

    @staticmethod
    def _take(chunks: list, n: int) -> DataSet:
        """Assemble n rows from the head of the chunk queue; partial chunks
        stay as zero-copy views, so total copying is O(total rows)."""
        need = n
        fx, fy, ffm, flm = [], [], [], []
        while need > 0:
            x, y, fm, lm = chunks[0]
            take = min(need, len(x))
            fx.append(x[:take])
            fy.append(y[:take])
            ffm.append(None if fm is None else fm[:take])
            flm.append(None if lm is None else lm[:take])
            if take == len(x):
                chunks.pop(0)
            else:
                chunks[0] = (x[take:], y[take:],
                             None if fm is None else fm[take:],
                             None if lm is None else lm[take:])
            need -= take

        def cat(parts):
            if all(p is None for p in parts):
                return None
            if any(p is None for p in parts):
                raise ValueError(
                    "Cannot re-batch a mix of masked and unmasked DataSets")
            return np.concatenate(parts)

        return DataSet(np.concatenate(fx), np.concatenate(fy),
                       cat(ffm), cat(flm))

    def _generate(self):
        chunks, count = [], 0
        for ds in self._base:
            chunks.append((ds.features, ds.labels,
                           ds.features_mask, ds.labels_mask))
            count += ds.num_examples()
            while count >= self._batch:
                yield self._take(chunks, self._batch)
                count -= self._batch
        if count:
            yield self._take(chunks, count)


class SamplingDataSetIterator(DataSetIterator):
    """Sample minibatches with replacement from a source DataSet (reference
    SamplingDataSetIterator.java)."""

    def __init__(self, source: DataSet, batch: int, num_samples: int,
                 seed: int = 123):
        self._source = source
        self._batch = batch
        self._num_samples = num_samples
        self._seed = seed
        self._pass = 0  # distinct draws every epoch

    def batch_size(self):
        return self._batch

    def _generate(self):
        rng = np.random.default_rng(self._seed + self._pass)
        self._pass += 1
        n = self._source.num_examples()
        # ceil: emit at least num_samples samples
        for _ in range(-(-self._num_samples // self._batch)):
            idx = rng.integers(0, n, self._batch)
            yield DataSet(
                self._source.features[idx], self._source.labels[idx],
                None if self._source.features_mask is None
                else self._source.features_mask[idx],
                None if self._source.labels_mask is None
                else self._source.labels_mask[idx])


class MultipleEpochsIterator(DataSetIterator):
    """Replay a base iterator N times as one pass (reference
    MultipleEpochsIterator.java)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self._epochs = epochs
        self._base = base

    def reset(self):
        self._base.reset()

    def batch_size(self):
        return self._base.batch_size()

    def _generate(self):
        for _ in range(self._epochs):
            self._base.reset()
            yield from self._base


# ------------------------------------------------------ MultiDataSet family
class MultiDataSetIterator:
    """Base multi-input/multi-output iterator (parity:
    org.nd4j.linalg.dataset.api.iterator.MultiDataSetIterator — the currency
    of ComputationGraph.fit)."""

    def __iter__(self):
        return self._generate()

    def _generate(self):
        raise NotImplementedError

    def reset(self):
        pass


class ListMultiDataSetIterator(MultiDataSetIterator):
    """Minibatch a MultiDataSet or list of them."""

    def __init__(self, data, batch: Optional[int] = None):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        if isinstance(data, MultiDataSet):
            if batch is None:
                data = [data]
            else:
                n = data.num_examples()
                data = [
                    MultiDataSet(
                        [f[i:i + batch] for f in data.features],
                        [l[i:i + batch] for l in data.labels],
                        None if data.features_masks is None else
                        [None if m is None else m[i:i + batch]
                         for m in data.features_masks],
                        None if data.labels_masks is None else
                        [None if m is None else m[i:i + batch]
                         for m in data.labels_masks])
                    for i in range(0, n, batch)]
        self._data = list(data)

    def _generate(self):
        yield from self._data


class MultiDataSetIteratorAdapter(MultiDataSetIterator):
    """DataSetIterator → MultiDataSetIterator (reference
    MultiDataSetIteratorAdapter.java)."""

    def __init__(self, base: DataSetIterator):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        self._base = base
        self._mds = MultiDataSet

    def reset(self):
        self._base.reset()

    def _generate(self):
        for ds in self._base:
            yield self._mds.from_dataset(ds)


class MultiDataSetWrapperIterator(DataSetIterator):
    """MultiDataSetIterator → DataSetIterator for single-in/single-out graphs
    (reference MultiDataSetWrapperIterator.java)."""

    def __init__(self, base: MultiDataSetIterator):
        self._base = base

    def reset(self):
        self._base.reset()

    def _generate(self):
        for mds in self._base:
            if len(mds.features) != 1 or len(mds.labels) != 1:
                raise ValueError(
                    "MultiDataSetWrapperIterator needs single-input/"
                    f"single-output data; got {len(mds.features)} inputs")
            fm = mds.features_masks[0] if mds.features_masks else None
            lm = mds.labels_masks[0] if mds.labels_masks else None
            yield DataSet(mds.features[0], mds.labels[0], fm, lm)


class JointMultiDataSetIterator(MultiDataSetIterator):
    """Zip several DataSetIterators into one MultiDataSet stream (reference
    JointMultiDataSetIterator.java): input i / label i come from iterator i;
    with ``output_index`` set, labels come from that single iterator."""

    def __init__(self, *iterators: DataSetIterator,
                 output_index: Optional[int] = None):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        self._its = iterators
        self._out = output_index
        self._mds = MultiDataSet

    def reset(self):
        for it in self._its:
            it.reset()

    def _generate(self):
        for group in zip(*self._its):
            feats = [ds.features for ds in group]
            fmasks = [ds.features_mask for ds in group]
            if self._out is None:
                labels = [ds.labels for ds in group]
                lmasks = [ds.labels_mask for ds in group]
            else:
                labels = [group[self._out].labels]
                lmasks = [group[self._out].labels_mask]
            any_fm = any(m is not None for m in fmasks)
            any_lm = any(m is not None for m in lmasks)
            yield self._mds(feats, labels,
                            fmasks if any_fm else None,
                            lmasks if any_lm else None)


class AsyncMultiDataSetIterator(MultiDataSetIterator):
    """Background prefetch for MultiDataSets (reference
    AsyncMultiDataSetIterator.java) — same bounded-queue overlap as
    AsyncDataSetIterator."""

    _END = object()

    def __init__(self, base: MultiDataSetIterator, queue_size: int = 4):
        self._base = base
        self._queue_size = queue_size

    def reset(self):
        self._base.reset()

    def _generate(self):
        yield from _async_generate(self._base, self._queue_size, self._END)


class EarlyTerminationMultiDataSetIterator(MultiDataSetIterator):
    """Cap minibatches (reference EarlyTerminationMultiDataSetIterator.java)."""

    def __init__(self, base: MultiDataSetIterator, max_batches: int):
        self._base = base
        self._max = max_batches

    def reset(self):
        self._base.reset()

    def _generate(self):
        for i, mds in enumerate(self._base):
            if i >= self._max:
                break
            yield mds


def __getattr__(name):
    # lazy re-export (PEP 562): perf.prefetch imports DataSetIterator from
    # this module, so an eager import here would be circular
    if name == "DevicePrefetchIterator":
        from deeplearning4j_tpu_torch.perf.prefetch import DevicePrefetchIterator
        return DevicePrefetchIterator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
