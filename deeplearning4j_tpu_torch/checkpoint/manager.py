"""Asynchronous, crash-consistent checkpointing with exact-step resume
(counterpart of ``deeplearning4j_tpu/checkpoint/manager.py``: the same
triggers, journal, retention, fall-back and resume arithmetic, over the
same zip and manifest, so either package's manager reads the other's
checkpoints).

- **Snapshot on the training thread, write on a worker thread.** ``save``
  copies parameters, layer state, updater state, the dropout generator's
  state and the step/epoch counters to the host and returns; a bounded
  queue hands the snapshot to a writer thread, so the step loop never
  blocks on disk. The port updates its masters in place, so the copy must
  be finished before ``save`` returns (``utils/serialization.py::
  snapshot_training_state``); CUDA tensors go through pinned host buffers
  that are reused once the writer has committed them. ``async_write=False``
  commits synchronously.
- **Atomic, journaled commits through pluggable storage.** Bytes are
  committed atomically by a :class:`~deeplearning4j_tpu_torch.checkpoint.
  storage.StorageBackend` (local tmp/ + fsync + rename by default; an
  object store via ``ObjectStoreBackend``; transient-fault retries via
  ``RetryingBackend``), then the entry (with the payload's sha256) is
  journaled into a checksummed ``manifest.json`` (checkpoint/manifest.py).
  A torn write is detected, and ``restore_latest`` falls back to the last
  complete checkpoint — identically through any backend.
- **Retention.** ``keep_last=N`` bounds disk; ``keep_best`` ("min"/"max"
  over the ``metric`` passed to ``save``) pins the best checkpoint outside
  that window.
- **Triggers.** ``save_every_n_steps`` / ``save_every_secs`` are evaluated
  by ``step_end``, which ``fit(..., checkpoint_manager=)`` calls after
  every batch on ``MultiLayerNetwork`` and ``ComputationGraph``.
- **Exact-step resume.** A checkpoint records ``batch_in_epoch``; the model
  ``restore_latest`` returns carries a :class:`ResumeState`, and the next
  ``fit`` treats ``num_epochs`` as the run's TOTAL target — it skips the
  already-consumed batches of the interrupted epoch and continues the
  restored generator, so resume is bitwise-identical to the uninterrupted
  run.
- **Sharded sets.** ``sharded=True`` writes each checkpoint as a shard
  set (checkpoint/sharded.py) journaled as one entry with a sha256 and a
  block summary a shard, committed only once every shard is durable; the
  restore walk reassembles a set written by any number of hosts, and
  ``restore_blocks`` fetches only the shards holding the blocks asked for.
  A torn manifest is rebuilt from the whole checkpoints and the complete
  shard sets in storage.
- **Several processes.** With ``torch.distributed`` initialised at a
  world size above 1 (``parallel.ClusterTrainer``, the elastic worker),
  rank 0 writes and every rank meets it at ``torch.distributed.barrier``
  under a ``CollectiveWatchdog`` deadline (``barrier_timeout_s``), so the
  ranks' save points stay in lockstep and a dead peer raises instead of
  hanging. Parameters are replicated over the ranks, so a sharded save
  writes one shard (rank 0's) holding every leaf whole, read by any
  world size of either package. ``save_every_secs`` is single-process
  only (local clocks drift); a multi-process run uses
  ``save_every_n_steps``.

The manager also implements the early-stopping saver protocol
(``save_best_model`` / ``save_latest_model`` / ``get_best_model``).

Restores build the network on ``device`` (``cuda`` unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import List, Optional

log = logging.getLogger(__name__)


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointError(RuntimeError):
    """A background write failed; re-raised on the training thread at the
    next save/flush/close so errors are never silently swallowed."""


@dataclasses.dataclass
class ResumeState:
    """Where a restored model stopped. ``fit`` consumes this marker: it
    runs epochs ``epoch .. num_epochs-1`` and skips the first
    ``batch_in_epoch`` batches of the resumed epoch."""
    step: int
    epoch: int
    batch_in_epoch: int
    path: str


class CheckpointManager:
    """See module docstring. Typical use::

        cm = CheckpointManager("ckpts", save_every_n_steps=100, keep_last=3)
        net.fit(data, num_epochs=10, checkpoint_manager=cm)
        ...                                  # preemption / crash
        cm = CheckpointManager("ckpts")      # fresh process
        net = cm.restore_latest()            # falls back past torn files
        net.fit(data, num_epochs=10, checkpoint_manager=cm)  # exact resume

    or, restart-proof end to end (checkpoint/resume.py turns the crash +
    restore + refit loop into one call)::

        train_until(net, data, num_epochs=10, checkpoint_manager=cm)

    ``storage`` accepts any checkpoint/storage.py backend — e.g.
    ``CheckpointManager(storage=RetryingBackend(ObjectStoreBackend(bucket)))``
    lands checkpoints in an object store and rides out transient faults;
    ``directory`` alone keeps the historical local-filesystem behavior.
    """

    def __init__(self, directory: Optional[str] = None,
                 save_every_n_steps: Optional[int] = None,
                 save_every_secs: Optional[float] = None,
                 keep_last: Optional[int] = None,
                 keep_best: Optional[str] = None,
                 async_write: bool = True,
                 queue_depth: int = 2,
                 save_updater: bool = True,
                 storage=None,
                 sharded: bool = False,
                 device=None,
                 barrier_timeout_s: float = 300.0):
        if save_every_n_steps is not None and save_every_n_steps < 1:
            raise ValueError("save_every_n_steps must be >= 1")
        if keep_best not in (None, "min", "max"):
            raise ValueError("keep_best must be None, 'min' or 'max'")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        if directory is None and storage is None:
            raise ValueError("need a directory or a storage backend")
        self.directory = None if directory is None else str(directory)
        self.save_every_n_steps = save_every_n_steps
        self.save_every_secs = save_every_secs
        self.keep_last = keep_last
        self.keep_best = keep_best
        self.async_write = bool(async_write)
        self.save_updater = bool(save_updater)
        self.device = device
        self.barrier_timeout_s = float(barrier_timeout_s)
        # sharded=True: each save writes a shard set (per-host shard files
        # + one set entry in the journal); sharded saves are synchronous
        self.sharded = bool(sharded)
        # optional fencing hook run immediately before a journal commit;
        # raising aborts the commit (payloads stay orphaned, never
        # journaled). The elastic layer points this at its membership
        # generation check so a stale, evicted leader cannot journal a
        # checkpoint behind the live generation's back.
        self.commit_guard: Optional[callable] = None
        from deeplearning4j_tpu_torch.checkpoint import manifest as mf
        from deeplearning4j_tpu_torch.checkpoint.storage import LocalFSBackend
        from deeplearning4j_tpu_torch.utils.serialization import HostStaging
        self._mf = mf
        # ``storage`` (checkpoint/storage.py StorageBackend) decouples the
        # journal + payloads from the local filesystem: LocalFSBackend is
        # the historical default, ObjectStoreBackend lands checkpoints in a
        # GCS-style store, RetryingBackend rides transient faults out
        self._storage = (storage if storage is not None
                         else LocalFSBackend(self.directory))
        if self.directory is not None and storage is None:
            os.makedirs(self.directory, exist_ok=True)
        self._storage.clean_orphans()  # partial writes from a crash
        self._lock = threading.Lock()          # guards _entries + manifest
        try:
            entries = mf.load_manifest(self._storage)
        except mf.ManifestError as e:
            log.warning("%s — rebuilding from storage scan", e)
            entries = None
        if entries is None:
            from deeplearning4j_tpu_torch.checkpoint import sharded as shd
            rebuilt_sharded = shd.scan_shard_sets(self._storage)
            if mf.scan_checkpoint_files(self._storage) or rebuilt_sharded:
                # torn OR missing manifest over surviving checkpoint files:
                # rebuild the journal — sha recomputed AND the per-entry
                # metadata (step/metric/...) read back out of each zip, so
                # restore_best / retention / checkpoints() keep working
                # after the rebuild, not just restore_latest. Complete
                # shard SETS rebuild as sharded entries; incomplete sets
                # (a crash between shard puts and the journal write) are
                # skipped like tmp/ orphans.
                entries = []
                for e_ in mf.scan_checkpoint_files(self._storage):
                    rebuilt = self._entry_from_object(e_["file"])
                    if rebuilt is not None:
                        entries.append(rebuilt)
                entries.extend(rebuilt_sharded)
                entries.sort(key=lambda e: (int(e.get("step", 0)), int(e.get("seq", 0))))
                mf.write_manifest(self._storage, entries)
        self._entries: List[dict] = entries or []
        self.last_refresh_error: Optional[BaseException] = None
        self._seq = max((int(e.get("seq", 0)) for e in self._entries),
                        default=0)
        self._batch_in_epoch = 0
        self._last_save_t = time.monotonic()
        # step-trigger watermark: resumes the cadence from the last
        # committed checkpoint when re-opening an existing directory
        self._last_save_step = (int(self._entries[-1].get("step", 0))
                                if self._entries else 0)
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._queue_depth = max(1, int(queue_depth))
        self._write_err: Optional[BaseException] = None
        self._fenced_model = None
        self.saves_requested = 0
        self.saves_fenced = 0
        self.saves_committed = 0
        # pinned host buffers for the snapshots, reused once committed
        self._staging = HostStaging()
        # the last saves' costs: snapshot ms on the training thread, ms a
        # save waited for a full queue (backpressure), commit ms on the
        # writer and its parts (zip bytes, sha256, storage write)
        self.timings = {k: deque(maxlen=1024)
                        for k in ("snapshot_ms", "queue_wait_ms", "commit_ms", "zip_ms",
                                  "sha256_ms", "write_ms")}
        self.backpressure_waits = 0
        # obs: commit/restore durations + bytes land in the process-wide
        # registry (the counters above are absorbed at scrape time)
        from deeplearning4j_tpu_torch.obs.registry import (
            absorb_checkpoint_manager, get_registry)
        reg = get_registry()
        self._m_commit_ms = reg.histogram(
            "checkpoint_commit_ms", unit="ms",
            help="wall time of one checkpoint payload write + journal "
                 "commit (storage put + manifest)")
        self._m_bytes_written = reg.counter(
            "checkpoint_bytes_written_total", unit="bytes",
            help="checkpoint payload bytes committed to storage")
        self._m_restore_ms = reg.histogram(
            "checkpoint_restore_ms", unit="ms",
            help="wall time of one checkpoint restore (fetch + verify + "
                 "deserialize)")
        self._m_bytes_restored = reg.counter(
            "checkpoint_bytes_restored_total", unit="bytes",
            help="checkpoint payload bytes read back during restores")
        absorb_checkpoint_manager(reg, self)

    def _entry_from_object(self, filename: str) -> Optional[dict]:
        """Reconstruct a full journal entry from a checkpoint zip's own
        metadata (manifest-rebuild path); None if the object is unreadable."""
        import hashlib as _hashlib
        import io
        import json
        import zipfile
        try:
            data = self._storage.get(filename)
            sha = _hashlib.sha256(data).hexdigest()
            with zipfile.ZipFile(io.BytesIO(data), "r") as z:
                meta = json.loads(z.read("metadata.json"))
            if meta.get("shard"):
                return None  # a per-host shard, not a whole checkpoint
            return {
                "file": filename,
                "seq": int(meta.get("seq", 0)),
                "step": int(meta.get("iteration", 0)),
                "epoch": int(meta.get("epoch", 0)),
                "batch_in_epoch": int(meta.get("batch_in_epoch", 0)),
                "metric": meta.get("metric"),
                "wall_time": meta.get("wall_time"),
                "sha256": sha,
                "size": len(data),
            }
        except Exception as e:
            log.warning("skipping unreadable checkpoint %s during manifest "
                        "rebuild (%s: %s)", filename, type(e).__name__, e)
            return None

    # --------------------------------------------------------------- triggers
    def _secs_trigger_due(self) -> bool:
        """The wall-clock trigger, single process only: local clocks drift
        across processes, and a save on one but not its peers would desync
        the checkpoint barrier."""
        if _world_size() > 1:
            raise ValueError(
                "save_every_secs is single-process only: local clocks drift across "
                "processes, so the time trigger would fire on some ranks and not "
                "others and desync the checkpoint barrier; use save_every_n_steps")
        return (time.monotonic() - self._last_save_t) >= self.save_every_secs

    def save_due(self, model, epoch_end: bool = False) -> bool:
        """Whether :meth:`step_end` (:meth:`epoch_end` with ``epoch_end``)
        would save ``model`` now. A caller that readies the model for a
        save only when one comes (tensor parallelism gathers its slices)
        asks first and passes the answer on as ``due``, so the time
        trigger is read once."""
        if self._fenced_model is not None and model is not self._fenced_model:
            return False
        if epoch_end:
            return self.save_every_secs is not None and self._secs_trigger_due()
        n = self.save_every_n_steps
        # threshold, not exact modulo: tbptt batches advance iteration by
        # SEVERAL windows per step_end, so `iteration % n == 0` would fire
        # only at lcm(windows, n) — or never — instead of every ~n steps
        due = bool(n) and (model.iteration - self._last_save_step) >= n
        if not due and self.save_every_secs is not None:
            due = self._secs_trigger_due()
        return due

    def step_end(self, model, batch_in_epoch: Optional[int] = None,
                 due: Optional[bool] = None):
        """Called by ``fit`` after every optimizer step (``model.iteration``
        already incremented). ``batch_in_epoch`` is the number of batches
        consumed so far in the CURRENT epoch — what exact-step resume skips.
        ``due``: :meth:`save_due`'s answer, when the caller asked first."""
        if self._fenced_model is not None and model is not self._fenced_model:
            return  # stale thread: must not touch triggers or resume state
        if batch_in_epoch is not None:
            self._batch_in_epoch = int(batch_in_epoch)
        if self.save_due(model) if due is None else due:
            self.save(model)

    def epoch_end(self, model, due: Optional[bool] = None):
        """Epoch boundary: resume state resets to batch 0 of the (already
        incremented) next epoch; the time trigger may still fire. ``due``
        as for :meth:`step_end`."""
        if self._fenced_model is not None and model is not self._fenced_model:
            return  # stale thread: must not touch triggers or resume state
        self._batch_in_epoch = 0
        if self.save_due(model, epoch_end=True) if due is None else due:
            self.save(model)

    # ------------------------------------------------------------------ fence
    def fence(self, model):
        """Accept saves only from ``model`` from now on (``None`` lifts the
        fence). The auto-resume driver re-fences to each restored model:
        an ABANDONED fit thread (a watchdog-timed-out attempt that cannot
        be cancelled, only outlived) may wake later and try to checkpoint
        its stale lineage through this same manager — the fence drops
        those commits instead of letting them become ``restore_latest``'s
        newest entry behind the recovered run's back."""
        self._fenced_model = model

    # ------------------------------------------------------------------- save
    def save(self, model, metric: Optional[float] = None,
             wait: bool = False) -> Optional[str]:
        """Snapshot ``model`` and commit it (async by default). Returns the
        checkpoint filename, or ``None`` for a fenced-out model (see
        :meth:`fence`).
        ``metric`` (lower/higher better per ``keep_best``) feeds best-model
        retention and ``restore_best``."""
        if self._fenced_model is not None and model is not self._fenced_model:
            self.saves_fenced += 1
            log.warning(
                "dropping checkpoint save from a fenced-out model (stale "
                "lineage — an abandoned fit thread?); the manager is "
                "fenced to a different model object")
            return None
        self._raise_pending()
        # both trigger watermarks advance on EVERY rank, or a non-writer
        # would re-trigger each step and desync the barrier count
        self._last_save_t = time.monotonic()
        self._last_save_step = int(model.iteration)
        if self.sharded:
            return self._save_sharded(model, metric)
        multi = _world_size() > 1
        if multi and _rank() != 0:
            # non-writers only barrier, in lockstep with rank 0's save
            self._barrier("checkpoint save")
            return None
        from deeplearning4j_tpu_torch.utils.serialization import snapshot_training_state
        t0 = time.perf_counter()
        snap = snapshot_training_state(model, self._staging)
        self.timings["snapshot_ms"].append((time.perf_counter() - t0) * 1000.0)
        if not self.save_updater:
            snap["updater_state"] = None
        self._seq += 1
        extra = {
            "seq": self._seq,
            "batch_in_epoch": self._batch_in_epoch,
            "wall_time": time.time(),
            "metric": None if metric is None else float(metric),
        }
        filename = f"ckpt-{snap['iteration']:010d}-{self._seq:05d}.zip"
        self.saves_requested += 1
        if self.async_write:
            self._ensure_worker()
            t0 = time.perf_counter()
            if self._q.full():
                self.backpressure_waits += 1
            self._q.put((snap, extra, filename))  # bounded: backpressure,
            # a slow disk can't accumulate unbounded host snapshots
            self.timings["queue_wait_ms"].append((time.perf_counter() - t0) * 1000.0)
        else:
            self._write_and_commit(snap, extra, filename)
        if multi:
            self._barrier("checkpoint save")
        if wait:
            self.flush()
        return filename

    # ------------------------------------------------------ saver protocol
    # (duck-typed EarlyStoppingConfiguration.model_saver backend)
    def save_best_model(self, model, score):
        if self.keep_best is None and self.keep_last is not None:
            # saver contract: get_best_model must return the BEST model,
            # so the best checkpoint must be pinned outside the keep_last
            # window (early stopping minimizes its score → "min")
            log.info("CheckpointManager used as early-stopping saver with "
                     "keep_last but no keep_best — defaulting keep_best="
                     "'min' so retention cannot prune the best checkpoint")
            self.keep_best = "min"
        self.save(model, metric=score)

    def save_latest_model(self, model, score):
        self.save(model, metric=score)

    def get_best_model(self, template=None):
        return self.restore_best()

    # ------------------------------------------------------------ worker side
    def _ensure_worker(self):
        if self._worker is not None and self._worker.is_alive():
            return
        self._q = queue.Queue(maxsize=self._queue_depth)
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="checkpoint-writer", daemon=True)
        self._worker.start()

    _SENTINEL = object()

    def _worker_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is CheckpointManager._SENTINEL:
                    return
                snap, extra, filename = item
                try:
                    self._write_and_commit(snap, extra, filename)
                except BaseException as e:  # surfaced on the training thread
                    log.exception("checkpoint write failed for %s", filename)
                    self._write_err = e
            finally:
                self._q.task_done()

    # ---------------------------------------------------------- sharded save
    def _save_sharded(self, model, metric: Optional[float]) -> Optional[str]:
        """Write this process's shard, then journal the set as one entry
        (its sha256 and block summary) once it is durable: the commit of
        the SET is atomic, and a crash before the journal write leaves an
        orphaned shard the restore walk never sees. Always synchronous, as
        in the JAX package. Rank 0 writes the one shard of the set (the
        parameters are replicated, so it holds every leaf whole); the other
        ranks meet it at the same two barriers."""
        from deeplearning4j_tpu_torch.checkpoint import sharded as shd
        t0 = time.perf_counter()
        self._seq += 1  # every rank: the sequence stays agreed fleet-wide
        if _world_size() > 1 and _rank() != 0:
            self._barrier("sharded payloads durable")
            self._barrier("sharded journal")
            return None
        snap = shd.shard_snapshot(model)
        if not self.save_updater:
            snap["updaterState"] = None
        extra = {
            "seq": self._seq,
            "batch_in_epoch": self._batch_in_epoch,
            "wall_time": time.time(),
            "metric": None if metric is None else float(metric),
        }
        base = f"ckpt-{snap['iteration']:010d}-{self._seq:05d}"
        name = shd.shard_object_name(base, 0, 1)
        self.saves_requested += 1
        shard_bytes = shd.shard_zip_bytes(snap, extra)
        self._storage.put(name, shard_bytes)
        self._m_bytes_written.inc(len(shard_bytes))
        self._barrier("sharded payloads durable")
        data = self._storage.get(name)  # read-back doubles as a
        shards = [{  # read-your-writes durability probe
            "file": name,
            "sha256": hashlib.sha256(data).hexdigest(),
            "size": len(data),
            # journaled block coverage: lets a selective restore
            # (sharded.fetch_blocks) decide which shard OBJECTS it needs
            # without fetching any payload
            "blocks": shd.shard_block_summary(data),
        }]
        entry = {
            "file": f"{base}.sharded",
            "sharded": True,
            "num_hosts": 1,
            "shards": shards,
            "seq": extra["seq"],
            "step": snap["iteration"],
            "epoch": snap["epoch"],
            "batch_in_epoch": extra["batch_in_epoch"],
            "metric": extra["metric"],
            "wall_time": extra["wall_time"],
            "sha256": None,
            "size": sum(s["size"] for s in shards),
        }
        try:
            if self.commit_guard is not None:
                self.commit_guard()  # raising aborts the commit
            with self._lock:
                self._entries.append(entry)
                self._entries = self._apply_retention(self._entries)
                self._mf.write_manifest(self._storage, self._entries)
        except BaseException:
            # the un-journaled shard set must not survive: it is a COMPLETE
            # set, and a later manifest-loss rebuild (scan_shard_sets) would
            # resurrect the very checkpoint the guard refused to commit
            for s in shards:
                try:
                    self._storage.delete(s["file"])
                except Exception as de:
                    log.warning("could not delete aborted shard %s (%s: %s)",
                                s["file"], type(de).__name__, de)
            raise
        self.saves_committed += 1
        self._barrier("sharded journal")
        self._m_commit_ms.observe((time.perf_counter() - t0) * 1000.0)
        return entry["file"]

    def _write_and_commit(self, snap: dict, extra: dict, filename: str):
        from deeplearning4j_tpu_torch.obs.trace import get_tracer
        from deeplearning4j_tpu_torch.utils.serialization import (checkpoint_zip_bytes,
                                                                  release_snapshot)
        t0 = time.perf_counter()
        try:
            data = checkpoint_zip_bytes(snap, extra)
        finally:
            # the zip holds its own copy: the pinned buffers go back
            release_snapshot(snap, self._staging)
        t1 = time.perf_counter()
        sha = hashlib.sha256(data).hexdigest()
        t2 = time.perf_counter()
        # fsync_directory deferred to the manifest write below (same dir):
        # the journal entry can never become durable before the payload
        # (a local-fs hint; object-store puts are durable on return)
        self._storage.put(filename, data, fsync_directory=False)
        for key, ms in (("zip_ms", t1 - t0), ("sha256_ms", t2 - t1),
                        ("write_ms", time.perf_counter() - t2)):
            self.timings[key].append(ms * 1000.0)
        entry = {
            "file": filename,
            "seq": extra["seq"],
            "step": snap["iteration"],
            "epoch": snap["epoch"],
            "batch_in_epoch": extra["batch_in_epoch"],
            "metric": extra["metric"],
            "wall_time": extra["wall_time"],
            "sha256": sha,
            "size": len(data),
        }
        try:
            if self.commit_guard is not None:
                self.commit_guard()  # raising aborts the journal commit
            with self._lock:
                self._entries.append(entry)
                self._entries = self._apply_retention(self._entries)
                self._mf.write_manifest(self._storage, self._entries)
        except BaseException:
            # the un-journaled payload must not survive a guard abort: a
            # later manifest-loss scan would resurrect the very
            # checkpoint the guard refused to commit
            try:
                self._storage.delete(filename)
            except Exception as de:
                log.warning("could not delete aborted checkpoint %s "
                            "(%s: %s)", filename, type(de).__name__, de)
            raise
        self.saves_committed += 1
        commit_ms = (time.perf_counter() - t0) * 1000.0
        self.timings["commit_ms"].append(commit_ms)
        self._m_commit_ms.observe(commit_ms)
        self._m_bytes_written.inc(len(data))
        get_tracer().event("checkpoint.commit", file=filename,
                           step=snap.get("iteration"), bytes=len(data),
                           ms=round(commit_ms, 2))

    def _best_entry(self, entries: List[dict],
                    direction: Optional[str] = None) -> Optional[dict]:
        direction = direction or self.keep_best or "min"
        scored = [e for e in entries if e.get("metric") is not None]
        if not scored:
            return None
        key = (lambda e: e["metric"])
        return (min if direction == "min" else max)(scored, key=key)

    def _apply_retention(self, entries: List[dict]) -> List[dict]:
        if self.keep_last is None or len(entries) <= self.keep_last:
            return entries
        keep = set(id(e) for e in entries[-self.keep_last:])
        if self.keep_best:
            best = self._best_entry(entries)
            if best is not None:
                keep.add(id(best))
        kept, pruned = [], []
        for e in entries:
            (kept if id(e) in keep else pruned).append(e)
        from deeplearning4j_tpu_torch.checkpoint.storage import StorageError
        for e in pruned:
            # a sharded entry's payload is its shard SET; the entry's own
            # "file" is a virtual name with no object behind it
            names = ([s["file"] for s in e["shards"]] if e.get("sharded")
                     else [e["file"]])
            for name in names:
                try:
                    self._storage.delete(name)
                except (OSError, StorageError) as err:
                    # retention is best-effort; the manifest is truth
                    log.warning("retention could not delete %s (%s: %s)",
                                name, type(err).__name__, err)
        return kept

    # ---------------------------------------------------------------- control
    def _raise_pending(self):
        err, self._write_err = self._write_err, None
        if err is not None:
            raise CheckpointError("background checkpoint write failed") from err

    def flush(self):
        """Block until every queued snapshot is committed; surface any
        background write error here."""
        if self._q is not None:
            self._q.join()
        self._raise_pending()

    def close(self, wait: bool = True):
        """Drain (when ``wait``) and stop the writer thread. With
        ``wait=False`` nothing here may block: if the writer is wedged on
        hung I/O with a full queue, the sentinel is simply dropped and the
        daemon thread dies with the process."""
        if self._worker is not None and self._worker.is_alive():
            if wait:
                self._q.join()
            try:
                self._q.put_nowait(CheckpointManager._SENTINEL)
            except queue.Full:
                pass  # wedged writer; see docstring
            self._worker.join(timeout=30 if wait else 1)
        self._worker = None
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # a crash mid-run must not hang on a drain of stale snapshots
        self.close(wait=exc_type is None)
        return False

    def checkpoints(self) -> List[dict]:
        """Committed entries, oldest first (copies)."""
        with self._lock:
            return [dict(e) for e in self._entries]

    def refresh(self) -> int:
        """Re-read the journal from storage and adopt it — for READ-side
        managers watching a store another process writes to (the serving
        hot-swap poller). Returns the number of entries now known. A torn
        or unreadable manifest keeps the previously known entries, and the
        fault is kept in ``last_refresh_error`` so a poller can back off."""
        from deeplearning4j_tpu_torch.checkpoint.storage import StorageError
        try:
            entries = self._mf.load_manifest(self._storage)
            self.last_refresh_error = None
        except (self._mf.ManifestError, StorageError, OSError) as e:
            log.warning("manifest refresh failed (%s: %s) — keeping the "
                        "previously loaded journal", type(e).__name__, e)
            entries = None
            self.last_refresh_error = e
        with self._lock:
            if entries is not None:
                self._entries = entries
                self._seq = max((int(e.get("seq", 0)) for e in self._entries),
                                default=self._seq)
            return len(self._entries)

    def latest_step(self) -> Optional[int]:
        """Step of the newest committed checkpoint, ``None`` when empty —
        the cheap "is there something newer?" probe hot-swap polls."""
        with self._lock:
            if not self._entries:
                return None
            return int(self._entries[-1].get("step", 0))

    # ---------------------------------------------------------------- restore
    def _restorable_entries(self) -> List[dict]:
        with self._lock:
            if self._entries:
                return [dict(e) for e in self._entries]
        return self._mf.scan_checkpoint_files(self._storage)

    def _try_restore(self, entry: dict, load_updater: bool,
                     arm_resume: bool):
        import io
        t0 = time.perf_counter()
        if entry.get("sharded"):
            # shard-set entry: fetch + sha-verify every shard, reassemble
            # the full state (a set written by any number of hosts — the
            # N→M reshard-on-restore path). Any failure raises and the walk
            # falls back a whole generation; shard sets never mix.
            from deeplearning4j_tpu_torch.checkpoint import sharded as shd
            model, meta = shd.restore_sharded(self._storage, entry,
                                              load_updater=load_updater,
                                              device=self.device)
        else:
            data = self._storage.get(entry["file"])  # StorageNotFoundError
            if entry.get("sha256") is not None and \
                    hashlib.sha256(data).hexdigest() != entry["sha256"]:
                raise CheckpointError(
                    f"checksum mismatch for {entry['file']} "
                    f"(torn/corrupt write)")
            from deeplearning4j_tpu_torch.utils.serialization import restore_checkpoint
            model, meta = restore_checkpoint(io.BytesIO(data), load_updater=load_updater,
                                             device=self.device)
        path = (os.path.join(self.directory, entry["file"])
                if self.directory is not None
                else f"{self._storage.describe()}/{entry['file']}")
        info = ResumeState(
            step=int(meta.get("iteration", 0)),
            epoch=int(meta.get("epoch", 0)),
            batch_in_epoch=int(meta.get("batch_in_epoch", 0)),
            path=path)
        # informational provenance, never consumed by fit
        model._restored_from = info
        # the consumable marker is armed ONLY on the crash-resume path
        # (restore_latest): a best-model restore is model SELECTION, and
        # arming it there would make the user's next fine-tune fit()
        # silently reinterpret num_epochs / skip unrelated batches
        model._resume_state = info if arm_resume else None
        self._m_restore_ms.observe((time.perf_counter() - t0) * 1000.0)
        self._m_bytes_restored.inc(int(entry.get("size", 0) or 0))
        return model

    def restore_latest(self, load_updater: bool = True):
        """Newest restorable checkpoint as a fresh model (``None`` when the
        directory holds none). Walks the journal newest-first; a missing
        file, sha mismatch or zip CRC failure logs and falls back to the
        previous complete checkpoint. The returned model carries a
        :class:`ResumeState` consumed by its next ``fit``."""
        if self._worker is not None and self._worker.is_alive():
            self.flush()
        for entry in reversed(self._restorable_entries()):
            try:
                return self._try_restore(entry, load_updater, arm_resume=True)
            except NotImplementedError:
                raise  # a member the port refuses is not a corrupt file
            except Exception as e:
                log.warning("checkpoint %s unusable (%s: %s); falling back",
                            entry.get("file"), type(e).__name__, e)
        return None

    def restore_best(self, direction: Optional[str] = None,
                     load_updater: bool = True):
        """Best-``metric`` restorable checkpoint (direction defaults to
        ``keep_best`` or "min"); falls back to next-best on corruption.
        Model selection, not crash resume: the returned model carries its
        provenance in ``_restored_from`` but NO consumable resume marker —
        a subsequent ``fit`` trains normally."""
        if self._worker is not None and self._worker.is_alive():
            self.flush()
        entries = [e for e in self._restorable_entries()
                   if e.get("metric") is not None]
        direction = direction or self.keep_best or "min"
        entries.sort(key=lambda e: e["metric"],
                     reverse=(direction == "max"))
        for entry in entries:
            try:
                return self._try_restore(entry, load_updater,
                                         arm_resume=False)
            except NotImplementedError:
                raise
            except Exception as e:
                log.warning("checkpoint %s unusable (%s: %s); falling back",
                            entry.get("file"), type(e).__name__, e)
        return None

    def restore_blocks(self, want, filename: Optional[str] = None,
                       trees=("coefficients", "updaterState")):
        """Streaming reshard-on-restore: fetch only the blocks ``want``
        selects from a SHARDED checkpoint (the newest one, or the named
        journal entry), without reassembling the full state — see
        ``checkpoint.sharded.fetch_blocks``. Returns host arrays."""
        from deeplearning4j_tpu_torch.checkpoint import sharded as shd
        if self._worker is not None and self._worker.is_alive():
            self.flush()
        entries = [e for e in self._restorable_entries() if e.get("sharded")]
        if filename is not None:
            entries = [e for e in entries if e.get("file") == filename]
        if not entries:
            raise CheckpointError(
                "no sharded checkpoint entry"
                + (f" named {filename!r}" if filename else "")
                + " to fetch blocks from")
        return shd.fetch_blocks(self._storage, entries[-1], want,
                                trees=tuple(trees))

    # ---------------------------------------------------------- multi-process
    def _barrier(self, what: str):
        """The bounded cross-process barrier: ``torch.distributed.barrier``
        under a ``CollectiveWatchdog`` deadline, so a dead peer at a
        checkpoint point raises ``CollectiveTimeoutError`` with the rank
        diagnostics instead of hanging the fleet. A no-op at one process."""
        if _world_size() <= 1:
            return
        import torch.distributed as dist
        from deeplearning4j_tpu_torch.parallel.watchdog import CollectiveWatchdog
        CollectiveWatchdog(timeout_s=self.barrier_timeout_s).call(
            dist.barrier, what=f"checkpoint barrier ({what})")


def consume_resume_state(model):
    """Pop the model's resume marker (set by ``restore_latest``); returns a
    :class:`ResumeState` or ``None``."""
    rs = getattr(model, "_resume_state", None)
    model._resume_state = None
    return rs


def resume_plan(model, num_epochs: int):
    """Consume the model's resume marker and return ``(epochs_to_run,
    skip_batches)`` for a fit targeting ``num_epochs`` TOTAL epochs. The
    single definition of the resume arithmetic, which both networks' ``fit``
    (``nn/training.py::TrainStep._fit_epochs``) call."""
    rs = consume_resume_state(model)
    if rs is None:
        return num_epochs, 0
    epochs_to_run = max(0, num_epochs - model.epoch)
    if epochs_to_run == 0:
        # legitimate when the checkpointed run had already reached the
        # target, but silent no-op training would be baffling otherwise —
        # say what happened and how to get plain semantics
        log.warning(
            "fit() on a restored model trains 0 epochs: num_epochs=%d is "
            "the run's TOTAL target and the checkpoint is already at epoch "
            "%d. To fine-tune a restored model with plain num_epochs "
            "semantics, clear the marker first (model._resume_state = "
            "None) or restore via restore_best().", num_epochs, model.epoch)
    return epochs_to_run, int(rs.batch_in_epoch)


_EXHAUSTED = object()


def skip_consumed_batches(data, skip: int):
    """One epoch pass over ``data`` minus its first ``skip`` batches (no
    step runs for them, so the restored chain stays exact).

    A seekable source (``iter_from(start_batch)``: ``datasets/sharded.py``'s
    ``ShardedReader``, also under ``AsyncDataSetIterator`` or
    ``DevicePrefetchIterator``) skips by seeking: the consumed batches are
    never read, sliced, ledgered or copied, at any world size. Any other
    source is iterated and its first ``skip`` batches are drawn and
    dropped. ``fit`` pads buckets on ``data`` before this call and
    prefetches this call's result, as in the JAX package, so a dropped
    batch is never staged onto the device.

    Raises when the stream ends before ``skip`` batches: the resume
    contract requires replaying the interrupted run's data in the same
    order, and an exhausted one-shot generator or shorter dataset would
    otherwise silently train a no-op epoch and diverge from the
    bitwise-resume guarantee."""
    if skip and hasattr(data, "iter_from"):
        return iter(data.iter_from(skip))
    it = iter(data)
    for i in range(skip):
        if next(it, _EXHAUSTED) is _EXHAUSTED:
            raise ValueError(
                f"exact-step resume expected to skip {skip} already-"
                f"consumed batches, but the data stream ended after {i} — "
                "resume requires a re-iterable source replaying the "
                "interrupted run's batches in the same order")
    return it
