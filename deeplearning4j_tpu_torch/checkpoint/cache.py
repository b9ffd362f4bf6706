"""CachedBackend — a local-disk LRU tier in front of any StorageBackend.

A replica fleet cold-starting from the lake, or a streaming index build
making a second pass over a corpus, should pay the wire cost once:

- **byte-budgeted LRU**: entries live as files under ``cache_dir``;
  filling past ``max_bytes`` evicts least-recently-used entries first.
  Objects larger than the whole budget bypass the cache entirely;
- **verify-on-read**: every hit is checked against the sha256 recorded at
  fill time — a rotted or truncated cache file is evicted and silently
  refetched from the inner backend (cache corruption must never be
  weaker than no cache);
- **single-flight**: concurrent ``get`` of the same missing key fetches
  once; the other callers wait and hit — a 16-replica fleet restoring the
  same checkpoint costs one wire transfer, not sixteen
  (``single_flight_waits`` counts the saved fetches);
- **write-through put**: the inner put commits first (the durability
  contract lives THERE), then the cache is refreshed, so read-your-writes
  holds through the cache.

``list``/``exists`` always delegate — the cache is never authoritative
about what exists, only about bytes already fetched. Stack order matters:
``CachedBackend(RetryingBackend(CloudObjectBackend(...)))`` gives hits
that never touch the retry layer and fills that get its full fault
handling (what :func:`~deeplearning4j_tpu_torch.checkpoint.cloud.backend_from_url`
builds).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.checkpoint.storage import StorageBackend

log = logging.getLogger(__name__)

__all__ = ["CachedBackend"]

_TMP_SUFFIX = ".tmp"
_META_SUFFIX = ".meta"
_DATA_SUFFIX = ".bin"


class CachedBackend(StorageBackend):
    """See module docstring. ``cache_dir`` is created on demand and may be
    shared across process restarts — surviving entries are re-indexed (and
    still verified on every read). ``verify=False`` trades the per-hit
    sha256 for speed; the chaos tests keep it on."""

    def __init__(self, inner: StorageBackend, cache_dir: str,
                 max_bytes: int = 256 << 20, *, verify: bool = True):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be > 0")
        self.inner = inner
        self.cache_dir = str(cache_dir)
        self.max_bytes = int(max_bytes)
        self.verify = bool(verify)
        self._lock = threading.Lock()           # index + counters
        self._key_locks: Dict[str, threading.Lock] = {}  # single-flight
        # name -> (entry_stem, size, sha256); insertion order = LRU order
        self._index: "OrderedDict[str, Tuple[str, int, str]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.corrupt_evictions = 0
        self.single_flight_waits = 0
        self._reindex()

    # ------------------------------------------------------------ indexing
    def _reindex(self):
        """Adopt entries left by a previous process: each ``.meta`` sidecar
        names its object and records the fill-time sha; LRU order is
        file mtime. Verification still happens per-read, so a stale or
        rotted adopted entry self-heals."""
        if not os.path.isdir(self.cache_dir):
            return
        found = []
        for fn in os.listdir(self.cache_dir):
            if not fn.endswith(_META_SUFFIX):
                continue
            stem = fn[:-len(_META_SUFFIX)]
            meta_path = os.path.join(self.cache_dir, fn)
            data_path = os.path.join(self.cache_dir, stem + _DATA_SUFFIX)
            try:
                with open(meta_path, "r", encoding="utf-8") as f:
                    meta = json.load(f)
                size = os.path.getsize(data_path)
                found.append((os.path.getmtime(data_path),
                              str(meta["name"]), stem, size,
                              str(meta["sha256"])))
            except (OSError, ValueError, KeyError):
                for p in (meta_path, data_path):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        for _, name, stem, size, sha in sorted(found):
            self._index[name] = (stem, size, sha)
            self._bytes += size
        self._evict_over_budget()

    @staticmethod
    def _stem(name: str) -> str:
        return hashlib.sha256(name.encode()).hexdigest()[:40]

    def _paths(self, stem: str) -> Tuple[str, str]:
        return (os.path.join(self.cache_dir, stem + _DATA_SUFFIX),
                os.path.join(self.cache_dir, stem + _META_SUFFIX))

    def _key_lock(self, name: str) -> threading.Lock:
        with self._lock:
            lock = self._key_locks.get(name)
            if lock is None:
                lock = self._key_locks[name] = threading.Lock()
            return lock

    # ------------------------------------------------------------ eviction
    def _evict_entry_locked(self, name: str, *, corrupt: bool = False):
        entry = self._index.pop(name, None)
        if entry is None:
            return
        stem, size, _ = entry
        self._bytes -= size
        if corrupt:
            self.corrupt_evictions += 1
        else:
            self.evictions += 1
        for p in self._paths(stem):
            try:
                os.remove(p)
            except OSError:
                pass

    def _evict_over_budget(self):
        while self._bytes > self.max_bytes and self._index:
            oldest = next(iter(self._index))
            self._evict_entry_locked(oldest)

    # ---------------------------------------------------------------- fill
    def _fill(self, name: str, data: bytes):
        if len(data) > self.max_bytes:
            return  # would evict the whole cache for one object
        os.makedirs(self.cache_dir, exist_ok=True)
        stem = self._stem(name)
        data_path, meta_path = self._paths(stem)
        sha = hashlib.sha256(data).hexdigest()
        tmp = data_path + _TMP_SUFFIX
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, data_path)  # atomic: readers see whole entries
        tmp = meta_path + _TMP_SUFFIX
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"name": name, "sha256": sha, "size": len(data)}, f)
        os.replace(tmp, meta_path)
        with self._lock:
            if name in self._index:
                _, old_size, _ = self._index.pop(name)
                self._bytes -= old_size
            self._index[name] = (stem, len(data), sha)
            self._bytes += len(data)
            self._evict_over_budget()

    def _read_entry(self, name: str) -> Optional[bytes]:
        """A verified cache hit, or None (absent OR corrupt — the corrupt
        entry is already evicted so the caller just refetches)."""
        with self._lock:
            entry = self._index.get(name)
        if entry is None:
            return None
        stem, size, sha = entry
        data_path, _ = self._paths(stem)
        try:
            with open(data_path, "rb") as f:
                data = f.read(size + 1)
        except OSError:
            data = None
        ok = (data is not None and len(data) == size
              and (not self.verify
                   or hashlib.sha256(data).hexdigest() == sha))
        if not ok:
            log.warning("cache entry for %s is corrupt or unreadable — "
                        "evicting and refetching from %s", name,
                        self.inner.describe())
            with self._lock:
                self._evict_entry_locked(name, corrupt=True)
            return None
        with self._lock:
            if name in self._index:
                self._index.move_to_end(name)
        return data

    # ----------------------------------------------------------- interface
    def get(self, name: str) -> bytes:
        data = self._read_entry(name)
        if data is not None:
            with self._lock:
                self.hits += 1
            return data
        klock = self._key_lock(name)
        waited = not klock.acquire(blocking=False)
        if waited:
            klock.acquire()
        try:
            if waited:
                # someone fetched while we queued — their fill is our hit
                data = self._read_entry(name)
                if data is not None:
                    with self._lock:
                        self.hits += 1
                        self.single_flight_waits += 1
                    return data
            data = self.inner.get(name)
            with self._lock:
                self.misses += 1
            self._fill(name, data)
            return data
        finally:
            klock.release()

    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        data = bytes(data)
        self.inner.put(name, data, fsync_directory=fsync_directory)
        self._fill(name, data)  # write-through AFTER the durable commit

    def list(self, prefix: str = "") -> List[str]:
        return self.inner.list(prefix)

    def delete(self, name: str):
        self.inner.delete(name)
        with self._lock:
            self._evict_entry_locked(name)

    def exists(self, name: str) -> bool:
        return self.inner.exists(name)

    def clean_orphans(self):
        swept = self.inner.clean_orphans()
        if os.path.isdir(self.cache_dir):
            for fn in os.listdir(self.cache_dir):
                if fn.endswith(_TMP_SUFFIX):
                    try:
                        os.remove(os.path.join(self.cache_dir, fn))
                    except OSError:
                        pass
        return swept

    # ------------------------------------------------------------- insight
    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "hit_rate": (self.hits / total) if total else 0.0,
                    "evictions": self.evictions,
                    "corrupt_evictions": self.corrupt_evictions,
                    "single_flight_waits": self.single_flight_waits,
                    "entries": len(self._index),
                    "bytes_cached": self._bytes,
                    "max_bytes": self.max_bytes}

    def describe(self) -> str:
        return f"CachedBackend({self.inner.describe()}, {self.cache_dir})"
