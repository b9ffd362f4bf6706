"""Pluggable checkpoint storage backends.

``CheckpointManager`` + the manifest journal speak one small byte-store
interface — :class:`StorageBackend` — instead of the filesystem directly,
so checkpoints can land anywhere that offers atomic single-object commits:

- :class:`LocalFSBackend` — the original behavior (tmp + fsync + rename in
  one directory, checkpoint/manifest.py's commit primitives) and the
  default when a manager is built from a ``directory``;
- :class:`ObjectStoreBackend` — GCS/S3-style put/get/list/delete
  semantics: whole-object atomic puts (an object is either absent or the
  complete last-put bytes — exactly the property the torn-write fallback
  relies on locally), no partial reads, list-by-prefix. The in-process
  dict implementation here is the test double; a real GCS client maps 1:1
  onto the five methods;
- :class:`RetryingBackend` — a wrapper adding bounded
  exponential-backoff-with-jitter retries (utils/backoff.py) and optional
  per-op timeouts, so TRANSIENT storage
  faults (throttling, flaky DCN, a 9p hiccup) never kill a training run.
  Permanent faults (:class:`PermanentStorageError`) are surfaced
  immediately — retrying a 403 only delays the real error.

Durability contract every backend must keep (what the manager's
payload-then-manifest commit depends on):

1. ``put`` is atomic: readers see the old object or the complete new one,
   never a prefix;
2. after ``put(name, data)`` returns, ``get(name)`` observes ``data``
   (read-your-writes within the writer process suffices);
3. ``get`` of a missing object raises :class:`StorageNotFoundError`.

Integrity does NOT move into the backend: the manifest layer keeps its
sha256-per-entry + self-checksummed journal through ANY backend, so a
bit-rotted object is detected and restore falls back identically whether
the bytes came from a local disk or an object store.

Counterpart of ``deeplearning4j_tpu/checkpoint/storage.py``: the same
interface, names and object layout, so a store written by either
package's manager is read by the other's.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.utils.backoff import backoff_delay

log = logging.getLogger(__name__)

__all__ = [
    "StorageBackend", "LocalFSBackend", "ObjectStoreBackend",
    "RetryingBackend", "StorageError", "TransientStorageError",
    "PermanentStorageError", "StorageNotFoundError", "as_backend",
    "ORPHAN_KEY_PREFIXES", "ORPHAN_KEY_SUFFIXES", "is_orphan_key",
    "sweep_orphan_keys",
]


class StorageError(RuntimeError):
    """Base class for backend failures."""


class TransientStorageError(StorageError):
    """A fault worth retrying: throttling, timeouts, flaky transport.

    ``retry_after_s`` carries a server-issued ``Retry-After`` hint when the
    fault came off the wire (a 429/503 from an object store);
    :class:`RetryingBackend` honors it in place of its own backoff delay,
    capped at the configured ceiling. ``None`` means "no hint — use the
    schedule"."""

    def __init__(self, *args, retry_after_s: Optional[float] = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class PermanentStorageError(StorageError):
    """A fault retries cannot fix: auth, missing bucket, bad request."""


class StorageNotFoundError(PermanentStorageError, FileNotFoundError):
    """The named object does not exist (also a FileNotFoundError so
    path-era callers' ``except FileNotFoundError`` keeps working)."""


class StorageBackend:
    """Abstract byte store for checkpoint payloads + the manifest journal.

    Implementations provide the five operations below; see the module
    docstring for the atomicity/visibility contract. ``describe()`` feeds
    log lines and ``ResumeState.path`` provenance strings."""

    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        """Atomically commit ``data`` as the object ``name``.

        ``fsync_directory`` is a LOCAL-FS durability hint (make the rename
        itself durable); object stores, where a put is durable on return,
        ignore it. The manager passes ``False`` for the checkpoint payload
        because the manifest put that immediately follows in the same
        directory covers it."""
        raise NotImplementedError

    def get(self, name: str) -> bytes:
        """The complete committed bytes of ``name``;
        :class:`StorageNotFoundError` when absent."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """Committed object names starting with ``prefix``, sorted."""
        raise NotImplementedError

    def delete(self, name: str):
        """Remove ``name``; deleting a missing object is a no-op (retention
        is best-effort and a retried delete must be idempotent)."""
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    # ------------------------------------------------------------- optional
    def clean_orphans(self):
        """Remove partial-write leftovers from a crash: local tmp files
        (:class:`LocalFSBackend`), orphaned ``tmp-``/``.part`` keys
        (:class:`ObjectStoreBackend`, :func:`sweep_orphan_keys`). Base class
        is a no-op
        for backends with nothing to clean."""

    def describe(self) -> str:
        return type(self).__name__


# Naming convention for keys that are, by construction, never a committed
# object: staging keys a writer parks bytes under before its final atomic
# commit. A crash between staging and commit leaves them behind;
# ``clean_orphans`` sweeps them because no reader ever looks for them.
ORPHAN_KEY_PREFIXES = ("tmp-",)
ORPHAN_KEY_SUFFIXES = (".tmp", ".part")


def is_orphan_key(name: str) -> bool:
    """True when ``name`` is a staging key under the orphan convention
    (a ``tmp-`` basename segment or a ``.tmp``/``.part`` suffix)."""
    base = name.rsplit("/", 1)[-1]
    return (base.startswith(ORPHAN_KEY_PREFIXES)
            or name.endswith(ORPHAN_KEY_SUFFIXES))


def sweep_orphan_keys(backend: "StorageBackend") -> List[str]:
    """Delete every orphan-convention key visible in ``backend`` and return
    the deleted names (:class:`ObjectStoreBackend` and
    :class:`LocalFSBackend` call it). Deletes are idempotent, so racing a concurrent
    sweep is harmless."""
    swept = [n for n in backend.list() if is_orphan_key(n)]
    for name in swept:
        backend.delete(name)
    if swept:
        log.info("swept %d orphan key(s) from %s: %s", len(swept),
                 backend.describe(), ", ".join(swept[:8]))
    return swept


class LocalFSBackend(StorageBackend):
    """One directory on a local filesystem — the manager's historical
    behavior, via the same tmp + fsync + rename commit primitive
    (manifest.atomic_write_bytes). Names may nest ("shards/x.npz", the
    data-lake key shape): they land as subdirectories and ``list``
    walks them back out with "/"-joined names."""

    def __init__(self, directory: str):
        self.directory = str(directory)

    def _ensure_dir(self):
        os.makedirs(self.directory, exist_ok=True)

    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        from deeplearning4j_tpu_torch.checkpoint.manifest import atomic_write_bytes
        self._ensure_dir()
        atomic_write_bytes(self.directory, name, data,
                           fsync_directory=fsync_directory)

    def get(self, name: str) -> bytes:
        path = os.path.join(self.directory, name)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            raise StorageNotFoundError(f"no such object: {path}") from e

    def list(self, prefix: str = "") -> List[str]:
        if not os.path.isdir(self.directory):
            return []
        from deeplearning4j_tpu_torch.checkpoint.manifest import TMP_DIR
        names = []
        for root, dirs, files in os.walk(self.directory):
            if root == self.directory and TMP_DIR in dirs:
                dirs.remove(TMP_DIR)  # staging area, never an object
            rel = os.path.relpath(root, self.directory)
            for n in files:
                name = n if rel == "." else \
                    os.path.join(rel, n).replace(os.sep, "/")
                if name.startswith(prefix):
                    names.append(name)
        return sorted(names)

    def delete(self, name: str):
        try:
            os.remove(os.path.join(self.directory, name))
        except FileNotFoundError:
            pass

    def exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self.directory, name))

    def clean_orphans(self):
        from deeplearning4j_tpu_torch.checkpoint.manifest import clean_tmp
        if os.path.isdir(self.directory):
            clean_tmp(self.directory)
        return sweep_orphan_keys(self)

    def describe(self) -> str:
        return f"LocalFSBackend({self.directory})"


class ObjectStoreBackend(StorageBackend):
    """GCS-style flat-namespace object store, modeled in process.

    ``store`` is the bucket: a plain dict shared between backend instances
    the way a real bucket is shared between processes — a serving process's
    manager and a training process's manager pointing at the same dict see
    each other's commits, which is what the hot-swap tests exercise.
    Objects are immutable snapshots (puts copy), so a caller mutating its
    buffer after ``put`` cannot corrupt the committed version."""

    # one lock per shared bucket dict, NOT per backend instance: two
    # instances over the same store (the trainer/serving shape above) must
    # exclude each other, or a reader's list() races a writer's put()
    # ("dictionary changed size during iteration"). Plain dicts can't be
    # weakly referenced, so the registry refcounts backends per store and
    # a weakref.finalize on each backend drops the entry when its last
    # user is collected — the store (and every checkpoint in it) is not
    # pinned for the life of the process.
    _STORE_LOCKS: Dict[int, list] = {}  # id(store) -> [store, lock, refs]
    _REGISTRY_LOCK = threading.Lock()

    @classmethod
    def _lock_for(cls, store: Dict[str, bytes], owner) -> threading.Lock:
        import weakref
        with cls._REGISTRY_LOCK:
            key = id(store)
            entry = cls._STORE_LOCKS.get(key)
            if entry is None:
                entry = [store, threading.Lock(), 0]
                cls._STORE_LOCKS[key] = entry
            entry[2] += 1

        def _release(key=key, entry=entry):
            with cls._REGISTRY_LOCK:
                entry[2] -= 1
                if entry[2] <= 0 and cls._STORE_LOCKS.get(key) is entry:
                    del cls._STORE_LOCKS[key]

        weakref.finalize(owner, _release)
        return entry[1]

    def __init__(self, store: Optional[Dict[str, bytes]] = None,
                 bucket: str = "checkpoints"):
        self._store: Dict[str, bytes] = store if store is not None else {}
        self.bucket = bucket
        self._lock = self._lock_for(self._store, self)
        self.op_counts: Dict[str, int] = {}

    def _count(self, op: str):
        self.op_counts[op] = self.op_counts.get(op, 0) + 1

    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        b = bytes(data)
        with self._lock:
            self._count("put")
            self._store[name] = b

    def get(self, name: str) -> bytes:
        with self._lock:
            self._count("get")
            try:
                return self._store[name]
            except KeyError as e:
                raise StorageNotFoundError(
                    f"no such object: {self.bucket}/{name}") from e

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            self._count("list")
            return sorted(n for n in self._store if n.startswith(prefix))

    def delete(self, name: str):
        with self._lock:
            self._count("delete")
            self._store.pop(name, None)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._store

    def clean_orphans(self):
        """Sweep orphaned staging keys (``tmp-``/``.part`` convention).

        Committed puts here are all-or-nothing, but clients that STAGE
        through the store (a resumable uploader parking parts, a copier
        writing ``<name>.tmp`` before a final put+delete) leave orphan keys
        behind on a crash — the object-store analogue of LocalFSBackend's
        tmp files."""
        sweep_orphan_keys(self)

    def describe(self) -> str:
        return f"ObjectStoreBackend({self.bucket})"


class RetryingBackend(StorageBackend):
    """Bounded exponential-backoff-with-jitter retries + per-op timeouts
    around any inner backend.

    Retries :class:`TransientStorageError`, ``OSError`` and ``TimeoutError``
    (``retry_on`` overrides); :class:`PermanentStorageError` and everything
    else propagate immediately. After ``max_retries`` failed retries the
    LAST transient error is re-raised — the caller (the manager's writer
    thread) then surfaces it as a CheckpointError instead of hanging.

    When a caught :class:`TransientStorageError` carries a server-issued
    ``retry_after_s`` hint (a 429/503 ``Retry-After`` header), the hint replaces that attempt's backoff
    delay, capped at ``max_backoff_s``; hint-less faults use the jittered
    schedule unchanged. ``retry_after_honored`` counts the substitutions.

    ``op_timeout_s`` bounds each attempt: the inner op runs on a worker
    thread (the watchdog's deadline pattern — a hung 9p fsync or stalled
    store RPC cannot be cancelled in-place) and an overrun counts as a
    transient fault. A timed-out attempt's thread is abandoned, daemon, and
    its late result discarded; leave ``op_timeout_s=None`` (default) to run
    ops inline with zero threading overhead.

    ``rng`` seeds the jitter for deterministic tests; ``sleep`` is
    injectable for the same reason."""

    _RETRYABLE = (TransientStorageError, OSError, TimeoutError)

    def __init__(self, inner: StorageBackend, max_retries: int = 5,
                 base_backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                 op_timeout_s: Optional[float] = None,
                 retry_on: Optional[tuple] = None,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.inner = inner
        self.max_retries = int(max_retries)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.op_timeout_s = op_timeout_s
        self.retry_on = tuple(retry_on) if retry_on is not None \
            else RetryingBackend._RETRYABLE
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self.attempts = 0
        self.retries = 0
        self.gave_up = 0
        self.retry_after_honored = 0

    # ---------------------------------------------------------- core loop
    def _attempt_once(self, op: str, fn: Callable):
        if self.op_timeout_s is None:
            return fn()
        done = threading.Event()
        out: dict = {}

        def run():
            try:
                out["v"] = fn()
            except BaseException as e:
                out["e"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name=f"storage-{op}-timeout")
        t.start()
        if not done.wait(self.op_timeout_s):
            raise TransientStorageError(
                f"storage op '{op}' on {self.inner.describe()} exceeded "
                f"its {self.op_timeout_s:.3g}s deadline")
        if "e" in out:
            raise out["e"]
        return out.get("v")

    def _with_retries(self, op: str, fn: Callable):
        # StorageNotFoundError subclasses FileNotFoundError (an OSError) —
        # but a missing object is a definitive answer, not a fault, and
        # retrying it would turn every restore fallback probe into a
        # multi-second backoff stall
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            self.attempts += 1
            try:
                return self._attempt_once(op, fn)
            except PermanentStorageError:
                raise
            except self.retry_on as e:
                last = e
                if attempt >= self.max_retries:
                    break
                hint = getattr(e, "retry_after_s", None)
                if hint is not None:
                    # the server said when to come back — believe it, but
                    # never wait longer than our own backoff ceiling (a
                    # hostile/buggy Retry-After must not stall the writer)
                    delay = min(max(float(hint), 0.0), self.max_backoff_s)
                    self.retry_after_honored += 1
                else:
                    delay = backoff_delay(attempt,
                                          base_s=self.base_backoff_s,
                                          cap_s=self.max_backoff_s,
                                          rng=self._rng)
                log.warning(
                    "storage op '%s' on %s failed (%s: %s) — retry %d/%d "
                    "in %.3fs", op, self.inner.describe(),
                    type(e).__name__, e, attempt + 1, self.max_retries,
                    delay)
                self.retries += 1
                self._sleep(delay)
        self.gave_up += 1
        log.error("storage op '%s' on %s failed after %d attempts — giving "
                  "up", op, self.inner.describe(), self.max_retries + 1)
        raise last

    # ----------------------------------------------------------- interface
    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        return self._with_retries(
            "put", lambda: self.inner.put(name, data,
                                          fsync_directory=fsync_directory))

    def get(self, name: str) -> bytes:
        return self._with_retries("get", lambda: self.inner.get(name))

    def list(self, prefix: str = "") -> List[str]:
        return self._with_retries("list", lambda: self.inner.list(prefix))

    def delete(self, name: str):
        return self._with_retries("delete", lambda: self.inner.delete(name))

    def exists(self, name: str) -> bool:
        return self._with_retries("exists", lambda: self.inner.exists(name))

    def clean_orphans(self):
        return self._with_retries("clean_orphans", self.inner.clean_orphans)

    def describe(self) -> str:
        return f"RetryingBackend({self.inner.describe()})"


def as_backend(target) -> StorageBackend:
    """Normalize a ``StorageBackend`` | directory path into a backend —
    the shim that lets the manifest functions keep their path-based
    signatures for existing callers."""
    if isinstance(target, StorageBackend):
        return target
    return LocalFSBackend(str(target))
