"""Streaming data plane: sharded, lease-based ETL with fleet-true
exactly-once resume (counterpart of ``deeplearning4j_tpu/datasets/sharded.py``:
the same epoch orders, lease objects and ledger, so a reader of either
package reads what the other wrote).

Training input used to be per-process host iterators: kill-and-resume
relied on ``ResumeState`` skipping consumed batches *within one process*,
so an elastic N→M reshard could silently replay or drop records. This
module makes the input tier a first-class distributed service — the
the equivalent of the reference's DataVec + Spark distributed
record readers feeding cluster DP (SURVEY L3 / §3.4):

- **Deterministic distributed shuffle.** Records are grouped into
  ``num_shards`` contiguous shards; an epoch's global order is a seeded
  permutation of shard indices (plus a per-shard seeded permutation
  within each shard), derived ONLY from ``(seed, epoch)`` — never from
  the world size, the worker, or global RNG state. The same seed
  therefore yields a bitwise-identical epoch record order at ANY world
  size, which is what makes an elastic N→M reshard mathematically
  invisible to training: global batch ``b`` holds the same records
  whether 1, 2 or 4 workers slice it.

- **Record-range leases over the StorageBackend.** Each worker claims a
  lease on the row-range it is about to consume (per
  ``lease_batches``-sized chunk of the epoch), through the SAME storage
  medium and freshness-under-TTL idiom as the elastic membership
  protocol (parallel/elastic.py) — read-back convergence, no
  compare-and-swap required, idempotent under ``RetryingBackend``
  retries (a retried put rewrites OUR claim; the read-back confirms it,
  so a transient fault can never double-claim a range). A fresh foreign
  lease whose row-slice overlaps ours means contention: a claim from a
  LATER generation proves we are the stale side of a membership change
  (:class:`StaleDataLeaseError` — the data-plane analogue of the
  checkpoint generation fence), an equal-or-older one is waited out
  bounded by the TTL (a SIGKILLed worker's lease simply expires).

- **Fleet-true exactly-once resume.** The reader is SEEKABLE:
  ``iter_from(batch)`` starts an epoch pass at any global batch index
  without materializing, staging or transferring the skipped records.
  ``checkpoint.manager.skip_consumed_batches`` uses it automatically, so
  a restore at ``(epoch e, batch k)`` — recorded by every checkpoint as
  ``batch_in_epoch`` — resumes by *seeking*, replaying ZERO consumed
  batches even when the restoring fleet has a different world size.
  ``bind_epoch`` ties the shuffle epoch to ``model.epoch`` (every fit
  wire-in binds it), so a restored model's reader reproduces exactly the
  interrupted epoch's order.

- **Per-record consumption ledger** (optional, chaos proof): each
  yielded batch writes an idempotent, keyed ledger object naming the
  exact records handed to the training loop.
  :func:`reconcile_ledger` reassembles the authoritative per-epoch
  record sequence (highest generation wins for a batch whose first
  training attempt was rolled back by a restore) and reports duplicates,
  gaps and contested batches — the artifact the 4→3 SIGKILL acceptance
  test asserts "no record seen twice / none dropped" against.

Stall attribution rides the existing ``train.data_wait`` spans (every
fit loop wraps its stream); the reader additionally exports lease-claim
latency, conflict counts and records-consumed through the obs registry.

Composition: a :class:`ShardedReader` is an ordinary
``DataSetIterator`` — wrap it in ``AsyncDataSetIterator`` for
host-thread prefetch and/or ``DevicePrefetchIterator`` for device
staging (both forward ``iter_from``/``bind_epoch``); build the dataset
from any live feed with :meth:`ShardedDataset.from_iterator` (e.g. a
``StreamingDataSetIterator`` segment pushed by an external producer).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import uuid
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

log = logging.getLogger(__name__)

DATA_LEASE_PREFIX = "dlease-"
LEDGER_PREFIX = "dledger-"

__all__ = [
    "DataLeaseError", "DataLeaseTimeout", "StaleDataLeaseError",
    "ShardedDataset", "ShardedReader", "ShardLeaseBoard",
    "LedgerReport", "reconcile_ledger",
    "DATA_LEASE_PREFIX", "LEDGER_PREFIX",
]


class DataLeaseError(RuntimeError):
    """Base class for data-plane lease failures."""


class DataLeaseTimeout(DataLeaseError):
    """A conflicting fresh lease did not clear within the claim deadline
    (a live foreign worker is consuming our range — systematic
    double-assignment, not a transient)."""


class StaleDataLeaseError(DataLeaseError):
    """A LATER-generation worker holds an overlapping range: this worker
    is the stale side of a membership change and must stop consuming —
    the data-plane analogue of the checkpoint generation fence."""


def _block_nbytes(block: dict) -> int:
    return sum(a.nbytes for a in block.values() if a is not None)


# ---------------------------------------------------------------- the plan
def _epoch_rng(*entropy: int) -> np.random.Generator:
    # seeded, instance-scoped RNG only: global-state shuffles here are the
    # deterministic-epoch hazard lint rule DLT011 exists to catch
    return np.random.default_rng([0xD17A, *[int(e) for e in entropy]])


class ShardedDataset:
    """Sharded view over an in-memory OR file-backed record source (see
    module docstring). In-memory: ``features``/``labels`` are indexable
    row arrays and ``num_shards`` defaults to about one shard per batch.
    File-backed: pass ``source=`` (a ``datasets.records.RecordSource`` —
    shard files in any StorageBackend, the lake included) and the shard
    layout IS the source's file layout; shard blocks are loaded lazily
    into an LRU of at most ``max_resident_shards``, so host RAM is
    bounded by in-flight shards, not the corpus
    (``peak_resident_bytes``/``resident_bytes()`` account for it). Both
    modes produce the identical epoch plan for the same
    ``(seed, epoch, shard layout)`` — shuffle, leases, seek and ledger
    semantics operate on row indices and do not know where rows live.

    ``store`` (any checkpoint/storage.py backend, or a directory path)
    enables the lease protocol; ``ledger=True`` additionally writes the
    per-record consumption ledger (chaos/audit runs — one small object
    put per batch per worker). Without a store the reader is a plain
    deterministic sharded iterator.

    ``fetch_hook(epoch, batch)`` — when set — runs before a batch is
    sliced, ledgered or yielded: the chaos tests SIGKILL the process
    there, the exact "between steps" shape of a real preemption."""

    def __init__(self, features=None, labels=None, *, batch_size: int,
                 num_shards: Optional[int] = None, seed: int = 0,
                 shuffle_within_shard: bool = True,
                 store=None, ledger: bool = False,
                 lease_batches: int = 8, lease_ttl_s: float = 10.0,
                 lease_wait_s: float = 30.0,
                 features_mask=None, labels_mask=None,
                 source=None, max_resident_shards: int = 8,
                 clock: Callable[[], float] = time.time):
        self.source = source
        self._resident: "OrderedDict[int, dict]" = OrderedDict()
        self.max_resident_shards = max(1, int(max_resident_shards))
        self.shard_loads = 0
        self.shard_hits = 0
        self.shard_evictions = 0
        self.peak_resident_bytes = 0
        self._resident_bytes = 0
        if source is not None:
            if features is not None or labels is not None:
                raise ValueError("pass arrays OR source=, not both")
            if num_shards is not None:
                raise ValueError("with source=, the shard layout IS the "
                                 "source's file layout — num_shards is "
                                 "not a free parameter")
            self.features = None
            self.labels = None
            self.features_mask = None
            self.labels_mask = None
            sizes = [int(s) for s in source.shard_sizes]
            if not sizes or any(s < 1 for s in sizes):
                raise ValueError(f"source has invalid shard sizes {sizes}")
            n = sum(sizes)
            self.num_shards = len(sizes)
            self._offsets = np.cumsum([0] + sizes).astype(np.int64)
            self._shards = [np.arange(self._offsets[i], self._offsets[i + 1],
                                      dtype=np.int64)
                            for i in range(len(sizes))]
        else:
            self.features = np.asarray(features)
            self.labels = None if labels is None else np.asarray(labels)
            self.features_mask = (None if features_mask is None
                                  else np.asarray(features_mask))
            self.labels_mask = (None if labels_mask is None
                                else np.asarray(labels_mask))
            n = int(self.features.shape[0])
        if batch_size < 1 or batch_size > n:
            raise ValueError(f"batch_size {batch_size} must be in [1, {n}]")
        self.batch_size = int(batch_size)
        self.num_records = n
        if source is None:
            # one shard ≈ one batch by default: shard-level permutation
            # then moves whole batch-sized blocks, the classic shuffle
            # granularity
            self.num_shards = int(num_shards) if num_shards is not None \
                else max(1, n // self.batch_size)
            if not (1 <= self.num_shards <= n):
                raise ValueError(f"num_shards {self.num_shards} must be in "
                                 f"[1, {n}]")
            self._shards = np.array_split(np.arange(n, dtype=np.int64),
                                          self.num_shards)
        self.seed = int(seed)
        self.shuffle_within_shard = bool(shuffle_within_shard)
        self.lease_batches = max(1, int(lease_batches))
        self.lease_ttl_s = float(lease_ttl_s)
        self.lease_wait_s = float(lease_wait_s)
        self.ledger = bool(ledger)
        self.clock = clock
        self.fetch_hook: Optional[Callable[[int, int], None]] = None
        if store is None:
            self.store = None
        else:
            from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
            self.store = as_backend(store)
        if self.ledger and self.store is None:
            raise ValueError("ledger=True needs a store to write it to")

    # ------------------------------------------------------------ builders
    @classmethod
    def from_dataset(cls, ds: DataSet, **kwargs) -> "ShardedDataset":
        return cls(ds.features, ds.labels,
                   features_mask=ds.features_mask,
                   labels_mask=ds.labels_mask, **kwargs)

    @classmethod
    def from_iterator(cls, iterator, **kwargs) -> "ShardedDataset":
        """Drain any DataSet iterable (a ``StreamingDataSetIterator``
        segment included) into an indexable record source — the bridge
        from push-driven ingestion to the seekable sharded plan."""
        fx, fy, ffm, flm = [], [], [], []
        for ds in iterator:
            fx.append(np.asarray(ds.features))
            fy.append(None if ds.labels is None else np.asarray(ds.labels))
            ffm.append(None if ds.features_mask is None
                       else np.asarray(ds.features_mask))
            flm.append(None if ds.labels_mask is None
                       else np.asarray(ds.labels_mask))
        if not fx:
            raise ValueError("from_iterator drained an empty stream")

        def cat(parts):
            if all(p is None for p in parts):
                return None
            if any(p is None for p in parts):
                raise ValueError("from_iterator got a mix of present and "
                                 "absent labels/masks across batches")
            return np.concatenate(parts)

        return cls(np.concatenate(fx), cat(fy), features_mask=cat(ffm),
                   labels_mask=cat(flm), **kwargs)

    @classmethod
    def from_source(cls, source, **kwargs) -> "ShardedDataset":
        """A lazily-loaded dataset over shard files
        (``datasets.records.RecordSource``) — the data-lake entry point:
        ``from_source(ShardFileSource(cloud_backend, "corpus/"), ...)``."""
        return cls(source=source, **kwargs)

    # ------------------------------------------------------------- shapes
    @property
    def feature_shape(self) -> tuple:
        """Per-record feature shape, known without loading any shard."""
        if self.source is not None:
            return tuple(self.source.feature_shape)
        return tuple(self.features.shape[1:])

    @property
    def label_width(self) -> Optional[int]:
        """Trailing label dimension, or None for an unlabeled corpus."""
        if self.source is not None:
            shape = self.source.label_shape
            return None if shape is None else int(shape[-1])
        if self.labels is None:
            return None
        return int(self.labels.shape[-1])

    # ---------------------------------------------------------- residency
    def resident_bytes(self) -> int:
        """Host bytes currently pinned by loaded shard blocks — the
        number the >RSS-budget acceptance test asserts stays a small
        multiple of shard size while the corpus is orders larger."""
        return self._resident_bytes

    def _shard_block(self, shard: int) -> dict:
        shard = int(shard)
        blk = self._resident.get(shard)
        if blk is not None:
            self._resident.move_to_end(shard)
            self.shard_hits += 1
            return blk
        blk = self.source.load_shard(shard)
        self.shard_loads += 1
        self._resident[shard] = blk
        self._resident_bytes += _block_nbytes(blk)
        while len(self._resident) > self.max_resident_shards:
            _, old = self._resident.popitem(last=False)
            self._resident_bytes -= _block_nbytes(old)
            self.shard_evictions += 1
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self._resident_bytes)
        return blk

    def _take_lazy(self, records: np.ndarray) -> DataSet:
        """Gather rows spanning shard files, preserving record order. A
        batch under the shard-block shuffle touches ~⌈batch/shard⌉+1
        shards, so the LRU makes this sequential-ish I/O, not random."""
        recs = np.asarray(records, dtype=np.int64)
        shard_ids = np.searchsorted(self._offsets, recs, side="right") - 1
        local = recs - self._offsets[shard_ids]
        fields: Dict[str, Optional[np.ndarray]] = {}
        for shard in np.unique(shard_ids):
            blk = self._shard_block(int(shard))
            mask = shard_ids == shard
            rows = local[mask]
            for f in ("features", "labels", "features_mask", "labels_mask"):
                src = blk.get(f)
                if src is None:
                    if fields.get(f) is not None:
                        raise ValueError(
                            f"shard {shard} of {self.source.describe()} "
                            f"lacks {f} that earlier shards have")
                    fields.setdefault(f, None)
                    continue
                out = fields.get(f)
                if out is None:
                    out = fields[f] = np.empty(
                        (len(recs),) + src.shape[1:], dtype=src.dtype)
                out[mask] = src[rows]
        return DataSet(fields["features"], fields.get("labels"),
                       features_mask=fields.get("features_mask"),
                       labels_mask=fields.get("labels_mask"))

    # ---------------------------------------------------------------- plan
    @property
    def num_batches(self) -> int:
        """Full global batches per epoch (a ragged tail is dropped — the
        static-shape contract; pad upstream via perf.bucketing to keep a
        tail)."""
        return self.num_records // self.batch_size

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's global record order — a pure function of
        ``(seed, epoch)``, identical at any world size."""
        perm = _epoch_rng(self.seed, epoch).permutation(self.num_shards)
        parts = []
        for s in perm:
            idx = self._shards[int(s)]
            if self.shuffle_within_shard:
                idx = idx[_epoch_rng(self.seed, epoch, int(s))
                          .permutation(len(idx))]
            parts.append(idx)
        return np.concatenate(parts)

    def batch_records(self, epoch: int, batch: int) -> np.ndarray:
        order = self.epoch_order(epoch)
        return order[batch * self.batch_size:(batch + 1) * self.batch_size]

    # -------------------------------------------------------------- reader
    def reader(self, rank: int = 0, world: int = 1,
               worker_id: Optional[str] = None,
               generation: int = 0) -> "ShardedReader":
        """This worker's view of the plan: the ``rank``-th row-slice of
        every global batch, lease-claimed chunk by chunk when a store is
        configured."""
        return ShardedReader(self, rank=rank, world=world,
                             worker_id=worker_id, generation=generation)

    def take(self, records: np.ndarray) -> DataSet:
        if self.source is not None:
            return self._take_lazy(records)
        return DataSet(
            self.features[records],
            None if self.labels is None else self.labels[records],
            features_mask=None if self.features_mask is None
            else self.features_mask[records],
            labels_mask=None if self.labels_mask is None
            else self.labels_mask[records])


# ================================================================== leases
def _slices_overlap(r1: int, w1: int, r2: int, w2: int) -> bool:
    """Whether rank r1's slice of a batch at world w1 intersects rank
    r2's at world w2 (exact integer cross-multiplication on the
    [r/w, (r+1)/w) fractions)."""
    return r1 * w2 < (r2 + 1) * w1 and r2 * w1 < (r1 + 1) * w2


class ShardLeaseBoard:
    """Record-range claims over the store (same lease idiom as
    parallel/elastic.py's LeaseBoard: freshness under a TTL, read-back
    convergence, no compare-and-swap).

    A claim is ``dlease-e<epoch>-c<chunk>-<worker>`` holding
    ``{worker, incarnation, rank, world, generation, time}``; claiming
    lists the chunk's prefix and treats any FRESH foreign lease whose
    row-slice overlaps ours as contention (wait bounded by
    ``wait_s``; a later-generation claimant raises
    :class:`StaleDataLeaseError` immediately). Puts are idempotent per
    worker — a ``RetryingBackend`` retry rewrites the same claim and the
    read-back confirms it, so transient storage faults cannot
    double-claim a range."""

    def __init__(self, store, worker_id: str, *, ttl_s: float = 10.0,
                 wait_s: float = 30.0, poll_s: float = 0.05,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self.store = as_backend(store)
        self.worker_id = str(worker_id)
        self.incarnation = uuid.uuid4().hex[:12]
        self.ttl_s = float(ttl_s)
        self.wait_s = float(wait_s)
        self.poll_s = float(poll_s)
        self.clock = clock
        self.sleep = sleep
        self._held: Dict[str, str] = {}  # name -> chunk key, for release
        self.claims = 0
        self.conflicts_waited = 0
        # obs: lease-claim latency is the data plane's availability cost;
        # conflicts are the signal a reshard (or a zombie) is in flight
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        self._m_claim_ms = reg.histogram(
            "data_plane_lease_claim_ms", unit="ms",
            help="wall time to claim one record-range lease (list + "
                 "conflict scan + put + read-back)")
        self._m_conflicts = reg.counter(
            "data_plane_lease_conflicts_total", unit="conflicts",
            help="fresh overlapping foreign leases encountered while "
                 "claiming record ranges")

    @staticmethod
    def _chunk_prefix(epoch: int, chunk: int) -> str:
        return f"{DATA_LEASE_PREFIX}e{epoch:04d}-c{chunk:06d}-"

    def _fresh(self, rec: dict) -> bool:
        return (self.clock() - float(rec.get("time", 0))) <= self.ttl_s

    def _conflicts(self, epoch: int, chunk: int, rank: int, world: int,
                   generation: int) -> List[dict]:
        out = []
        prefix = self._chunk_prefix(epoch, chunk)
        for name in self.store.list(prefix=prefix):
            try:
                rec = json.loads(self.store.get(name).decode())
            except Exception as e:
                # unreadable lease = expired/absent (elastic.py precedent)
                log.warning("unreadable data lease %s (%s: %s)", name,
                            type(e).__name__, e)
                continue
            if rec.get("worker") == self.worker_id:
                continue  # our own claim (or an older incarnation of us)
            if not self._fresh(rec):
                continue
            if _slices_overlap(rank, world, int(rec.get("rank", 0)),
                               int(rec.get("world", 1))):
                if int(rec.get("generation", 0)) > generation:
                    raise StaleDataLeaseError(
                        f"{self.worker_id} (gen {generation}) found a "
                        f"gen-{rec.get('generation')} lease by "
                        f"{rec.get('worker')} on epoch {epoch} chunk "
                        f"{chunk} — this worker is stale; stop consuming")
                out.append(rec)
        return out

    def claim(self, epoch: int, chunk: int, rank: int, world: int,
              generation: int = 0) -> str:
        """Claim ``(epoch, chunk)`` for our row-slice; returns the lease
        object name. Blocks (bounded) while a fresh overlapping foreign
        lease exists — a dead claimant's lease simply expires."""
        t0 = time.perf_counter()
        deadline = self.clock() + self.wait_s
        waited = False
        while True:
            others = self._conflicts(epoch, chunk, rank, world, generation)
            if not others:
                break
            if not waited:
                waited = True
                self.conflicts_waited += 1
                self._m_conflicts.inc()
                from deeplearning4j_tpu_torch.obs.trace import get_tracer
                get_tracer().event(
                    "data_plane.lease_wait", epoch=epoch, chunk=chunk,
                    holders=[o.get("worker") for o in others])
            if self.clock() > deadline:
                raise DataLeaseTimeout(
                    f"{self.worker_id}: record-range lease for epoch "
                    f"{epoch} chunk {chunk} still held by "
                    f"{[o.get('worker') for o in others]} after "
                    f"{self.wait_s:.0f}s — overlapping LIVE consumers "
                    "mean the fleet double-assigned a range")
            self.sleep(self.poll_s)
        name = self._chunk_prefix(epoch, chunk) + self.worker_id
        rec = {"worker": self.worker_id, "incarnation": self.incarnation,
               "rank": int(rank), "world": int(world),
               "generation": int(generation), "time": self.clock()}
        self.store.put(name, json.dumps(rec).encode())
        # read-back convergence: confirm the store holds OUR claim (a
        # retried put that actually landed twice is still just ours)
        back = json.loads(self.store.get(name).decode())
        if back.get("worker") != self.worker_id:
            raise DataLeaseError(
                f"lease read-back for {name} returned a claim by "
                f"{back.get('worker')!r}")
        self._held[name] = f"e{epoch}c{chunk}"
        self.claims += 1
        self._m_claim_ms.observe((time.perf_counter() - t0) * 1000.0)
        return name

    def release(self, name: str):
        self._held.pop(name, None)
        try:
            self.store.delete(name)
        except Exception as e:
            log.warning("data lease release %s failed (%s: %s)", name,
                        type(e).__name__, e)

    def release_all(self):
        """Best-effort release of every lease this board still holds —
        peers need not wait a TTL after a clean generation end."""
        for name in list(self._held):
            self.release(name)


# ================================================================== reader
class ShardedReader(DataSetIterator):
    """One worker's lease-claimed, seekable view of a
    :class:`ShardedDataset` (see module docstring). Yields the
    ``rank``-th row-slice of every global batch of the current epoch;
    re-iterating yields the next epoch (or whatever ``bind_epoch``'s
    provider says the epoch now is)."""

    def __init__(self, dataset: ShardedDataset, rank: int = 0,
                 world: int = 1, worker_id: Optional[str] = None,
                 generation: int = 0):
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        if dataset.batch_size % world:
            raise ValueError(
                f"global batch {dataset.batch_size} not divisible by "
                f"world {world} — every worker must take an equal "
                "row-slice (the ClusterTrainer equal-shard contract)")
        self.dataset = dataset
        self.rank = int(rank)
        self.world = int(world)
        self.generation = int(generation)
        self.worker_id = (str(worker_id) if worker_id is not None
                          else f"r{rank:03d}of{world:03d}-"
                               f"{uuid.uuid4().hex[:8]}")
        self._epoch_provider: Optional[Callable[[], int]] = None
        self._auto_epoch = 0
        self.batches_yielded = 0
        self.records_yielded = 0
        self.leases = None
        if dataset.store is not None:
            self.leases = ShardLeaseBoard(
                dataset.store, self.worker_id, ttl_s=dataset.lease_ttl_s,
                wait_s=dataset.lease_wait_s, clock=dataset.clock)
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        self._m_records = reg.counter(
            "data_plane_records_total", unit="records",
            help="records handed to the training loop by sharded readers "
                 "(process-local rows)")
        self._m_batches = reg.counter(
            "data_plane_batches_total", unit="batches",
            help="local batches yielded by sharded readers")
        self._m_ledger_writes = reg.counter(
            "data_plane_ledger_writes_total", unit="writes",
            help="consumption-ledger objects written (ledger-enabled "
                 "runs only)")

    # ----------------------------------------------------------- epoching
    def bind_epoch(self, provider: Callable[[], int]) -> "ShardedReader":
        """Tie the shuffle epoch to an external counter — every fit
        wire-in binds ``lambda: model.epoch``, so a restored model's
        reader reproduces the interrupted epoch exactly."""
        self._epoch_provider = provider
        return self

    def current_epoch(self) -> int:
        if self._epoch_provider is not None:
            return int(self._epoch_provider())
        return self._auto_epoch

    # ---------------------------------------------------------- iteration
    def batch_size(self) -> int:
        return self.dataset.batch_size // self.world

    def input_columns(self):
        return int(np.prod(self.dataset.feature_shape))

    def total_outcomes(self):
        return self.dataset.label_width

    def _generate(self):
        # raw stream: DataSetIterator.__iter__ applies pre_processor
        return self._iter_raw(0)

    def iter_from(self, start_batch: int):
        """One epoch pass beginning at global batch ``start_batch`` —
        the seek primitive exact-step resume uses: nothing before
        ``start_batch`` is fetched, sliced, ledgered or transferred.
        Applies the reader's ``pre_processor`` exactly like plain
        iteration does, so a resumed epoch's remainder sees the same
        transform as every other epoch."""
        gen = self._iter_raw(start_batch)
        if self.pre_processor is None:
            return gen
        return (self.pre_processor(d) for d in gen)

    def _iter_raw(self, start_batch: int):
        ds = self.dataset
        nb = ds.num_batches
        if start_batch > nb:
            raise ValueError(
                f"cannot seek to batch {start_batch}: the epoch has only "
                f"{nb} full batches — the resume cursor outran the data "
                "(changed dataset between runs?)")
        epoch = self.current_epoch()
        order = ds.epoch_order(epoch)
        local = self.batch_size()
        lo = self.rank * local
        held: Optional[str] = None
        try:
            for b in range(start_batch, nb):
                if self.leases is not None \
                        and (held is None or b % ds.lease_batches == 0):
                    prev, held = held, self.leases.claim(
                        epoch, b // ds.lease_batches, self.rank,
                        self.world, self.generation)
                    if prev is not None:
                        self.leases.release(prev)
                if ds.fetch_hook is not None:
                    ds.fetch_hook(epoch, b)
                recs = order[b * ds.batch_size + lo:
                             b * ds.batch_size + lo + local]
                if ds.ledger:
                    self._write_ledger(epoch, b, recs)
                self.batches_yielded += 1
                self.records_yielded += len(recs)
                self._m_batches.inc()
                self._m_records.inc(len(recs))
                yield ds.take(recs)
        finally:
            if held is not None and self.leases is not None:
                self.leases.release(held)
        if self._epoch_provider is None:
            self._auto_epoch += 1

    def _write_ledger(self, epoch: int, batch: int, records: np.ndarray):
        """Keyed, idempotent consumption record: re-training a batch that
        was rolled back by a restore overwrites the same slot at a newer
        generation instead of duplicating it."""
        name = (f"{LEDGER_PREFIX}e{epoch:04d}-b{batch:06d}-"
                f"r{self.rank:03d}of{self.world:03d}")
        self.dataset.store.put(name, json.dumps({
            "epoch": int(epoch), "batch": int(batch),
            "rank": self.rank, "world": self.world,
            "generation": self.generation, "worker": self.worker_id,
            "records": [int(r) for r in records],
            "time": self.dataset.clock(),
        }).encode())
        self._m_ledger_writes.inc()

    def release_all(self):
        if self.leases is not None:
            self.leases.release_all()


# ================================================================== ledger
@dataclasses.dataclass
class LedgerReport:
    """What the consumption ledger proves (see :func:`reconcile_ledger`)."""
    epochs: Dict[int, List[int]]       # epoch -> authoritative record order
    duplicates: List[tuple]            # (epoch, record) seen twice
    gaps: List[tuple]                  # (epoch, batch) with a torn cover
    contested: List[tuple]             # (epoch, batch, sorted generations)

    @property
    def clean(self) -> bool:
        return not self.duplicates and not self.gaps


def reconcile_ledger(store, batch_size: int) -> LedgerReport:
    """Reassemble the authoritative per-epoch record sequence from the
    ledger objects in ``store``.

    For each ``(epoch, batch)`` the entries of the HIGHEST generation
    present are authoritative — the storage-backed mirror of checkpoint
    rollback semantics: if a batch's first training attempt died before
    its step committed, the restore rolled those updates back and the
    re-training (at a newer generation, possibly a different world size)
    is the one that counts. Authoritative covers must tile the batch
    exactly (every rank of one world, ``batch_size`` records total);
    anything else lands in ``gaps``. ``contested`` lists batches whose
    slots hold more than one generation — the acceptance test
    cross-checks those against the checkpoint journal to prove no
    CONSUMED (committed) batch was ever replayed."""
    from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
    backend = as_backend(store)
    entries: Dict[tuple, List[dict]] = {}
    for name in backend.list(prefix=LEDGER_PREFIX):
        try:
            rec = json.loads(backend.get(name).decode())
            entries.setdefault(
                (int(rec["epoch"]), int(rec["batch"])), []).append(rec)
        except Exception as e:
            log.warning("unreadable ledger object %s (%s: %s)", name,
                        type(e).__name__, e)
    per_epoch: Dict[int, Dict[int, List[int]]] = {}
    gaps: List[tuple] = []
    contested: List[tuple] = []
    for (epoch, batch), recs in sorted(entries.items()):
        gens = sorted({int(r.get("generation", 0)) for r in recs})
        if len(gens) > 1:
            contested.append((epoch, batch, gens))
        top = [r for r in recs if int(r.get("generation", 0)) == gens[-1]]
        worlds = {int(r["world"]) for r in top}
        if len(worlds) != 1:
            gaps.append((epoch, batch))
            continue
        world = worlds.pop()
        by_rank = {int(r["rank"]): r for r in top}
        if sorted(by_rank) != list(range(world)):
            gaps.append((epoch, batch))
            continue
        seq: List[int] = []
        for r in range(world):
            seq.extend(int(x) for x in by_rank[r]["records"])
        if len(seq) != batch_size:
            gaps.append((epoch, batch))
            continue
        per_epoch.setdefault(epoch, {})[batch] = seq
    epochs: Dict[int, List[int]] = {}
    duplicates: List[tuple] = []
    for epoch, batches in per_epoch.items():
        seen: Dict[int, int] = {}
        order: List[int] = []
        for b in sorted(batches):
            for rec_id in batches[b]:
                if rec_id in seen:
                    duplicates.append((epoch, rec_id))
                seen[rec_id] = b
                order.append(rec_id)
        epochs[epoch] = order
    return LedgerReport(epochs=epochs, duplicates=duplicates, gaps=gaps,
                        contested=contested)
