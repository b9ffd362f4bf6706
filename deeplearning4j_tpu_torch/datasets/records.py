"""Record readers + the record→DataSet bridge (counterpart of
``deeplearning4j_tpu/datasets/records.py``; every reader and iterator
yields the JAX package's batches for the same input, bitwise).

Parity surface: DataVec's ``RecordReader`` SPI (datavec-api, external to the
reference repo) and the reference's
``deeplearning4j-core/.../datasets/datavec/RecordReaderDataSetIterator.java:51``
(labelIndex / labelIndexFrom-To / regression modes) and
``SequenceRecordReaderDataSetIterator.java`` (sequence + alignment modes).

Design: records are plain Python lists of values; batch assembly produces
contiguous numpy arrays once per minibatch (one host-to-device copy a
step, made by the network or by ``perf/prefetch.py``). The Writable type hierarchy
dissolves — numpy dtype promotion does the converter's job.

The FILE-BACKED tier (DataVec's distributed record readers, SURVEY L3):
:class:`RecordSource` is the lazy counterpart of the in-RAM arrays a
``ShardedDataset`` is normally built from — a corpus laid out as shard
objects in ANY ``StorageBackend`` (local dir, in-process bucket,
a cloud store behind the same interface), loaded one shard at a time.
:class:`ShardFileSource` reads the native ``.npz`` shard layout
(:func:`write_shards` produces it); :class:`CSVShardSource` reads a
prefix of CSV shard objects through the same column/label conventions as
:class:`RecordReaderDataSetIterator`. ``ShardedDataset(source=...)``
keeps its deterministic shuffle / lease / exactly-once semantics
unchanged — those operate on row indices, which a source serves lazily
with RAM bounded by the in-flight shard set.
"""

from __future__ import annotations

import csv
import io
import json
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import _one_hot as _one_hot_int
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    return _one_hot_int(np.asarray(idx).astype(np.int64), n)


class RecordReader:
    """Iterable of records; a record is a list of values (DataVec
    ``RecordReader.next()`` → List<Writable>)."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self):
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec CollectionRecordReader)."""

    def __init__(self, records: Sequence[Sequence]):
        self.records = list(records)

    def __iter__(self):
        return iter(self.records)


class CSVRecordReader(RecordReader):
    """CSV file/string reader (DataVec CSVRecordReader): ``skip_lines``
    header rows, custom delimiter, numeric fields parsed to float, other
    fields kept as strings."""

    def __init__(self, source: Union[str, Iterable[str]], skip_lines: int = 0,
                 delimiter: str = ","):
        self.source = source
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _lines(self):
        if isinstance(self.source, str):
            if os.path.exists(self.source):
                with open(self.source, "r", encoding="utf-8") as f:
                    yield from f
            else:
                yield from io.StringIO(self.source)
        else:
            yield from self.source

    def __iter__(self):
        reader = csv.reader(self._lines(), delimiter=self.delimiter)
        for i, row in enumerate(reader):
            if i < self.skip_lines or not row:
                continue
            yield [self._parse(v) for v in row]

    def numeric_matrix(self) -> Optional[np.ndarray]:
        """All-numeric fast path: the native one-pass parser
        (deeplearning4j_tpu_torch.native.parse_csv_numeric) turns the whole source
        into a float32 matrix without per-row Python objects. None when the
        native lib is absent or the data has strings/ragged rows — callers
        fall back to row iteration."""
        from deeplearning4j_tpu_torch.native import parse_csv_numeric
        if not isinstance(self.source, str):
            # a generator/file-object source may be one-shot: consuming it
            # here would leave the fallback row path empty, so the fast path
            # only applies to path/string sources
            return None
        if os.path.exists(self.source):
            with open(self.source, "rb") as f:
                data = f.read()
        else:
            data = self.source.encode("utf-8")
        return parse_csv_numeric(data, self.delimiter, self.skip_lines)

    @staticmethod
    def _parse(v: str):
        v = v.strip()
        try:
            return float(v)
        except ValueError:
            return v


class CSVSequenceRecordReader(RecordReader):
    """Sequence CSV reader (DataVec CSVSequenceRecordReader): each source —
    file path or list of lines — is one sequence; yields one list-of-records
    per sequence."""

    def __init__(self, sources: Sequence[Union[str, Sequence[str]]],
                 skip_lines: int = 0, delimiter: str = ","):
        self.sources = list(sources)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        for src in self.sources:
            yield list(CSVRecordReader(src, self.skip_lines, self.delimiter))


class RecordReaderDataSetIterator(DataSetIterator):
    """records → DataSet minibatches (reference
    RecordReaderDataSetIterator.java:51).

    - classification: ``label_index`` column holds the class id,
      ``num_possible_labels`` sets one-hot width
    - regression: ``regression=True`` with ``label_index`` (single target) or
      ``label_index_from``/``label_index_to`` (inclusive range of targets)
    - ``max_num_batches`` caps iteration (reference maxNumBatches)
    """

    def __init__(self, record_reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_possible_labels: int = -1,
                 regression: bool = False,
                 label_index_from: int = -1, label_index_to: int = -1,
                 max_num_batches: int = -1):
        self.reader = record_reader
        self._batch = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.label_index_from = label_index_from
        self.label_index_to = label_index_to
        self.max_num_batches = max_num_batches
        if (not regression and label_index >= 0 and label_index_from < 0
                and num_possible_labels <= 0):
            # per-batch inference would give inconsistent one-hot widths
            raise ValueError(
                "Classification mode needs num_possible_labels (the one-hot "
                "width must be fixed across minibatches)")
        self._label_map: dict = {}  # string label -> class index

    def reset(self):
        self.reader.reset()

    def batch_size(self):
        return self._batch

    def total_outcomes(self):
        if self.regression:
            if self.label_index_from >= 0:
                return self.label_index_to - self.label_index_from + 1
            return 1
        return self.num_possible_labels if self.num_possible_labels > 0 else None

    def _to_float(self, rows, what: str) -> np.ndarray:
        try:
            return np.asarray(rows, np.float32)
        except (ValueError, TypeError):
            bad = next((v for row in rows
                        for v in (row if isinstance(row, (list, tuple)) else [row])
                        if isinstance(v, str)), None)
            if bad is not None:
                raise ValueError(
                    f"Non-numeric value {bad!r} in {what}; map string fields "
                    "to numbers before batching (string class labels in the "
                    "label column are mapped automatically)") from None
            widths = sorted({len(r) for r in rows
                             if isinstance(r, (list, tuple))})
            raise ValueError(
                f"Cannot assemble {what} into an array"
                + (f": ragged record lengths {widths}" if len(widths) > 1
                   else "")) from None

    def _split(self, rows: List[list]):
        li = self.label_index
        if (not self.regression and li >= 0 and len(rows)
                and isinstance(rows[0][li], str)):
            # auto-map string class labels to stable indices in order of
            # first appearance (the common 'species name' CSV case)
            rows = [list(r) for r in rows]
            for r in rows:
                label = r[li]
                if label not in self._label_map:
                    if len(self._label_map) >= self.num_possible_labels:
                        raise ValueError(
                            f"More than num_possible_labels="
                            f"{self.num_possible_labels} distinct labels "
                            f"(new: {label!r})")
                    self._label_map[label] = len(self._label_map)
                r[li] = self._label_map[label]
        arr = self._to_float(rows, "record batch")
        if self.label_index_from >= 0:  # regression target range
            lo, hi = self.label_index_from, self.label_index_to
            labels = arr[:, lo:hi + 1]
            feats = np.concatenate([arr[:, :lo], arr[:, hi + 1:]], axis=1)
        elif self.label_index >= 0:
            labels = arr[:, self.label_index:self.label_index + 1]
            feats = np.concatenate(
                [arr[:, :self.label_index], arr[:, self.label_index + 1:]],
                axis=1)
            if not self.regression:
                labels = _one_hot(labels[:, 0], self.num_possible_labels)
        else:  # no labels: features only (autoencoder style — labels=features)
            feats = labels = arr
        return DataSet(feats, labels.astype(np.float32))

    def _generate(self):
        # native bulk path: one C++ pass over the bytes, then pure slicing
        mat = (self.reader.numeric_matrix()
               if hasattr(self.reader, "numeric_matrix") else None)
        if mat is not None:
            for k, s in enumerate(range(0, len(mat), self._batch)):
                if 0 < self.max_num_batches <= k:
                    return
                yield self._split(mat[s:s + self._batch])
            return
        rows, batches = [], 0
        for rec in self.reader:
            rows.append(rec)
            if len(rows) == self._batch:
                yield self._split(rows)
                rows, batches = [], batches + 1
                if 0 < self.max_num_batches <= batches:
                    return
        if rows:
            yield self._split(rows)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """sequence records → (batch, time, features) DataSets (reference
    SequenceRecordReaderDataSetIterator.java). Sequences in a batch are
    padded to the longest with features/labels masks (ALIGN_END of the
    reference's alignment modes)."""

    def __init__(self, reader: CSVSequenceRecordReader, batch_size: int,
                 label_index: int = -1, num_possible_labels: int = -1,
                 regression: bool = False):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        if not regression and label_index >= 0 and num_possible_labels <= 0:
            raise ValueError(
                "Sequence classification mode needs num_possible_labels")

    def reset(self):
        self.reader.reset()

    def batch_size(self):
        return self._batch

    def _assemble(self, seqs: List[np.ndarray]):
        T = max(s.shape[0] for s in seqs)
        li = self.label_index
        n_feat = seqs[0].shape[1] - (1 if li >= 0 else 0)
        n_lab = (self.num_possible_labels if not self.regression and li >= 0
                 else (1 if li >= 0 else n_feat))
        B = len(seqs)
        x = np.zeros((B, T, n_feat), np.float32)
        y = np.zeros((B, T, n_lab), np.float32)
        mask = np.zeros((B, T), np.float32)
        for i, s in enumerate(seqs):
            t = s.shape[0]
            mask[i, :t] = 1.0
            if li >= 0:
                feats = np.concatenate([s[:, :li], s[:, li + 1:]], axis=1)
                lab = s[:, li]
                x[i, :t] = feats
                if self.regression:
                    y[i, :t, 0] = lab
                else:
                    y[i, :t] = _one_hot(lab, n_lab)
            else:
                x[i, :t] = s
                y[i, :t] = s
        full = mask.all()
        return DataSet(x, y, None if full else mask, None if full else mask)

    def _generate(self):
        seqs = []
        for seq in self.reader:
            seqs.append(np.asarray(seq, np.float32))
            if len(seqs) == self._batch:
                yield self._assemble(seqs)
                seqs = []
        if seqs:
            yield self._assemble(seqs)


# ===================================================== file-backed sources
SHARD_META_NAME = "meta.json"
_SHARD_FIELDS = ("features", "labels", "features_mask", "labels_mask")


class RecordSource:
    """A corpus as an ordered list of shard files in a StorageBackend.

    The contract ``ShardedDataset(source=...)`` builds on:

    - ``shard_sizes``: rows per shard, fixed at construction (global row
      ``r`` lives at offset ``r - sum(sizes[:i])`` of shard ``i``);
    - ``load_shard(i)`` → ``{"features": arr, "labels": arr|None,
      "features_mask": ..., "labels_mask": ...}`` with exactly
      ``shard_sizes[i]`` rows — loaded on demand, never retained here
      (residency is the dataset's LRU's job);
    - ``feature_shape``/``label_shape``: per-record trailing shapes, known
      WITHOUT loading any shard (readers size their models from these).
    """

    shard_sizes: List[int]
    feature_shape: tuple
    label_shape: Optional[tuple]

    @property
    def num_shards(self) -> int:
        return len(self.shard_sizes)

    @property
    def num_records(self) -> int:
        return sum(self.shard_sizes)

    def load_shard(self, index: int) -> dict:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


def _shard_key(prefix: str, index: int) -> str:
    return f"{prefix}shard-{index:05d}.npz"


def write_shards(store, prefix: str, features, labels=None, *,
                 records_per_shard: int, features_mask=None,
                 labels_mask=None) -> "ShardFileSource":
    """Lay a corpus out as the native shard format: one ``.npz`` object
    per ``records_per_shard`` rows plus a trailing ``meta.json`` under
    ``prefix`` in any backend. The meta object is written LAST — it is
    the commit point a :class:`ShardFileSource` discovers the corpus
    through, so a writer that dies mid-layout leaves nothing readable."""
    from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
    backend = as_backend(store)
    features = np.asarray(features)
    n = int(features.shape[0])
    if records_per_shard < 1:
        raise ValueError("records_per_shard must be >= 1")
    arrays = {"features": features,
              "labels": None if labels is None else np.asarray(labels),
              "features_mask": (None if features_mask is None
                                else np.asarray(features_mask)),
              "labels_mask": (None if labels_mask is None
                              else np.asarray(labels_mask))}
    for field, arr in arrays.items():
        if arr is not None and arr.shape[0] != n:
            raise ValueError(f"{field} has {arr.shape[0]} rows, "
                             f"features has {n}")
    sizes = []
    for i, lo in enumerate(range(0, n, records_per_shard)):
        hi = min(n, lo + records_per_shard)
        buf = io.BytesIO()
        np.savez(buf, **{f: a[lo:hi] for f, a in arrays.items()
                         if a is not None})
        backend.put(_shard_key(prefix, i), buf.getvalue())
        sizes.append(hi - lo)
    meta = {"version": 1, "shard_sizes": sizes,
            "feature_shape": list(features.shape[1:]),
            "label_shape": (None if arrays["labels"] is None
                            else list(arrays["labels"].shape[1:])),
            "fields": [f for f, a in arrays.items() if a is not None]}
    backend.put(prefix + SHARD_META_NAME,
                json.dumps(meta, sort_keys=True).encode())
    return ShardFileSource(backend, prefix)


class ShardFileSource(RecordSource):
    """The native shard-file layout: ``<prefix>shard-NNNNN.npz`` objects
    described by ``<prefix>meta.json`` (see :func:`write_shards`), over
    any StorageBackend — the lake path feeds training through
    ``CloudObjectBackend`` + ``CachedBackend`` with exactly this class."""

    def __init__(self, store, prefix: str = "shards/"):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self.store = as_backend(store)
        self.prefix = str(prefix)
        try:
            meta = json.loads(self.store.get(self.prefix +
                                             SHARD_META_NAME).decode())
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no shard corpus at prefix {self.prefix!r} in "
                f"{self.store.describe()} — write_shards() commits "
                f"{SHARD_META_NAME} last; its absence means no corpus "
                "(or a writer that died mid-layout)") from None
        self.shard_sizes = [int(s) for s in meta["shard_sizes"]]
        self.feature_shape = tuple(meta["feature_shape"])
        self.label_shape = (None if meta.get("label_shape") is None
                            else tuple(meta["label_shape"]))
        self.fields = tuple(meta.get("fields", ("features",)))
        self.loads = 0
        self.bytes_loaded = 0

    def load_shard(self, index: int) -> dict:
        data = self.store.get(_shard_key(self.prefix, index))
        self.loads += 1
        self.bytes_loaded += len(data)
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            out = {f: (np.asarray(z[f]) if f in z.files else None)
                   for f in _SHARD_FIELDS}
        got = 0 if out["features"] is None else out["features"].shape[0]
        if got != self.shard_sizes[index]:
            raise ValueError(
                f"shard {index} of {self.describe()} has {got} rows, "
                f"meta says {self.shard_sizes[index]} — corpus rewritten "
                "under a live reader?")
        return out

    def describe(self) -> str:
        return f"ShardFileSource({self.store.describe()}, {self.prefix!r})"


class CSVShardSource(RecordSource):
    """CSV shard objects under a prefix (DataVec's CSV readers over an
    object store): every object ``<prefix>*`` is one shard, shards ordered
    by name. Label handling follows
    :class:`RecordReaderDataSetIterator` — ``label_index`` column one-hot
    to ``num_possible_labels`` wide (or kept scalar under
    ``regression=True``); without a ``label_index`` the rows are
    features-only. Labels must be NUMERIC class ids — string labels would
    need a first-appearance map whose order depends on shard visit order,
    which a deterministic shuffle cannot allow.

    Row counts are taken in one pass over the corpus at construction
    (each object read once — through a ``CachedBackend`` that pass also
    warms the cache); bytes are NOT retained."""

    def __init__(self, store, prefix: str, *, label_index: int = -1,
                 num_possible_labels: int = -1, regression: bool = False,
                 skip_lines: int = 0, delimiter: str = ","):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self.store = as_backend(store)
        self.prefix = str(prefix)
        self.label_index = int(label_index)
        self.num_possible_labels = int(num_possible_labels)
        self.regression = bool(regression)
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        if not regression and label_index >= 0 and num_possible_labels <= 0:
            raise ValueError("Classification mode needs num_possible_labels")
        self.shard_names = [n for n in self.store.list(prefix=self.prefix)
                            if not n.endswith(SHARD_META_NAME)]
        if not self.shard_names:
            raise FileNotFoundError(
                f"no CSV shards under prefix {self.prefix!r} in "
                f"{self.store.describe()}")
        self.loads = 0
        self.bytes_loaded = 0
        sizes, widths = [], set()
        for name in self.shard_names:
            rows = self._parse(self.store.get(name), name)
            sizes.append(rows.shape[0])
            widths.add(rows.shape[1])
        if len(widths) != 1:
            raise ValueError(f"CSV shards disagree on column count: "
                             f"{sorted(widths)}")
        self.shard_sizes = sizes
        width = widths.pop()
        n_feat = width - (1 if self.label_index >= 0 else 0)
        self.feature_shape = (n_feat,)
        if self.label_index < 0:
            self.label_shape = None
        elif self.regression:
            self.label_shape = (1,)
        else:
            self.label_shape = (self.num_possible_labels,)

    def _parse(self, data: bytes, name: str) -> np.ndarray:
        self.loads += 1
        self.bytes_loaded += len(data)
        reader = CSVRecordReader(data.decode("utf-8"),
                                 skip_lines=self.skip_lines,
                                 delimiter=self.delimiter)
        mat = reader.numeric_matrix()
        if mat is None:
            rows = list(reader)
            if any(isinstance(v, str) for r in rows for v in r):
                raise ValueError(
                    f"CSV shard {name} has non-numeric fields — lake CSV "
                    "shards must be fully numeric (see class docstring)")
            mat = np.asarray(rows, np.float32)
        if mat.ndim != 2:
            raise ValueError(f"CSV shard {name} is empty or ragged")
        return mat

    def load_shard(self, index: int) -> dict:
        name = self.shard_names[index]
        mat = self._parse(self.store.get(name), name)
        li = self.label_index
        if li < 0:
            return {"features": mat, "labels": None,
                    "features_mask": None, "labels_mask": None}
        labels = mat[:, li:li + 1]
        feats = np.concatenate([mat[:, :li], mat[:, li + 1:]], axis=1)
        if not self.regression:
            labels = _one_hot(labels[:, 0], self.num_possible_labels)
        return {"features": feats, "labels": labels.astype(np.float32),
                "features_mask": None, "labels_mask": None}

    def describe(self) -> str:
        return f"CSVShardSource({self.store.describe()}, {self.prefix!r})"
