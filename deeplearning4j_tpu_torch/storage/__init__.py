"""Stats storage: persistable training-stats records, keyed by session
(counterpart of ``deeplearning4j_tpu/storage/__init__.py``).

Parity surface: reference ``deeplearning4j-core/.../api/storage/StatsStorage.java``
(the listing/query API), ``StatsStorageRouter.java`` (the write API),
``deeplearning4j-ui-model/.../storage/InMemoryStatsStorage.java`` and
``FileStatsStorage.java`` / ``J7FileStatsStorage.java`` (implementations).

Records are plain JSON-serializable dicts, the JAX package's: they come off
the host side of the training loop (``ui.stats.StatsListener`` reduces each
leaf on its device and ships scalars and histogram counts), so a JSON-lines
file written by either package is read by the other with the same answers to
every query.

Record contract (written by ``ui.stats.StatsListener``):
  - static-info records: ``{"kind": "static", "session_id", "type_id",
    "worker_id", "timestamp", ...payload}`` — one per (session, type, worker)
  - update records: ``{"kind": "update", "session_id", "type_id",
    "worker_id", "timestamp", "iteration", ...payload}``
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple


class StatsStorageEvent:
    """What changed (reference StatsStorageEvent / StatsStorageListener)."""

    NEW_SESSION = "new_session"
    NEW_TYPE_ID = "new_type_id"
    NEW_WORKER_ID = "new_worker_id"
    POST_STATIC_INFO = "post_static_info"
    POST_UPDATE = "post_update"

    def __init__(self, event_type: str, session_id: str, type_id: str,
                 worker_id: Optional[str], timestamp: float):
        self.event_type = event_type
        self.session_id = session_id
        self.type_id = type_id
        self.worker_id = worker_id
        self.timestamp = timestamp


class BaseStatsStorage:
    """In-memory index + optional persistence hook (reference
    BaseCollectionStatsStorage.java). Also acts as its own router: the
    reference's ``StatsStorage extends StatsStorageRouter`` collapse."""

    def __init__(self):
        self._lock = threading.RLock()
        # static: (session, type, worker) -> record
        self._static: Dict[Tuple[str, str, str], dict] = {}
        # updates: (session, type, worker) -> list of records sorted by arrival
        self._updates: Dict[Tuple[str, str, str], List[dict]] = {}
        self._listeners: List[Callable[[StatsStorageEvent], None]] = []

    # ------------------------------------------------------------ write API
    def put_static_info(self, record: dict):
        key = self._key(record)
        with self._lock:
            new_session = key[0] not in {k[0] for k in
                                         list(self._static) + list(self._updates)}
            self._static[key] = record
            self._persist(record)
        if new_session:
            self._fire(StatsStorageEvent.NEW_SESSION, *key,
                       record.get("timestamp", 0.0))
        self._fire(StatsStorageEvent.POST_STATIC_INFO, *key,
                   record.get("timestamp", 0.0))

    def put_update(self, record: dict):
        key = self._key(record)
        with self._lock:
            self._updates.setdefault(key, []).append(record)
            self._persist(record)
        self._fire(StatsStorageEvent.POST_UPDATE, *key,
                   record.get("timestamp", 0.0))

    def _key(self, record: dict) -> Tuple[str, str, str]:
        return (record["session_id"], record.get("type_id", ""),
                record.get("worker_id", ""))

    def _persist(self, record: dict):  # overridden by FileStatsStorage
        pass

    def _fire(self, event_type, session, type_id, worker, ts):
        ev = StatsStorageEvent(event_type, session, type_id, worker, ts)
        for cb in list(self._listeners):
            cb(ev)

    # ------------------------------------------------------------- read API
    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in list(self._static) + list(self._updates)})

    def session_exists(self, session_id: str) -> bool:
        return session_id in self.list_session_ids()

    def list_type_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({k[1] for k in list(self._static) + list(self._updates)
                           if k[0] == session_id})

    def list_worker_ids(self, session_id: str,
                        type_id: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted({k[2] for k in list(self._static) + list(self._updates)
                           if k[0] == session_id
                           and (type_id is None or k[1] == type_id)})

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            if worker_id is not None:
                return self._static.get((session_id, type_id, worker_id))
            for k, v in self._static.items():
                if k[0] == session_id and k[1] == type_id:
                    return v
        return None

    def get_all_updates(self, session_id: str, type_id: str,
                        worker_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = []
            for k, recs in self._updates.items():
                if k[0] == session_id and k[1] == type_id and \
                        (worker_id is None or k[2] == worker_id):
                    out.extend(recs)
            out.sort(key=lambda r: (r.get("timestamp", 0), r.get("iteration", 0)))
            return out

    def get_all_updates_after(self, session_id: str, type_id: str,
                              timestamp: float,
                              worker_id: Optional[str] = None) -> List[dict]:
        return [r for r in self.get_all_updates(session_id, type_id, worker_id)
                if r.get("timestamp", 0) > timestamp]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: Optional[str] = None) -> Optional[dict]:
        updates = self.get_all_updates(session_id, type_id, worker_id)
        return updates[-1] if updates else None

    def num_update_records(self, session_id: str, type_id: str) -> int:
        return len(self.get_all_updates(session_id, type_id))

    # -------------------------------------------------------- notifications
    def register_storage_listener(self, cb: Callable[[StatsStorageEvent], None]):
        self._listeners.append(cb)

    def deregister_storage_listener(self, cb):
        if cb in self._listeners:
            self._listeners.remove(cb)

    def close(self):
        pass


class InMemoryStatsStorage(BaseStatsStorage):
    """Ephemeral storage (reference InMemoryStatsStorage.java)."""


class FileStatsStorage(BaseStatsStorage):
    """JSON-lines-backed storage (reference FileStatsStorage.java /
    J7FileStatsStorage.java — MapDB/SQLite replaced by an append-only
    JSON-lines file). Reopening the same path reloads all records."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._read_offset = 0
        if os.path.exists(path):
            self.refresh()
        # newline="" disables platform newline translation so byte offsets
        # tracked by refresh() stay exact everywhere
        self._fh = open(path, "a", encoding="utf-8", newline="")

    def refresh(self) -> int:
        """Ingest records appended to the file by another process since the
        last read (the ``python -m deeplearning4j_tpu_torch.ui`` live-tail path).
        Returns the number of new records."""
        if not os.path.exists(self.path):
            return 0
        n = 0
        with self._lock, open(self.path, "rb") as f:  # binary: exact offsets
            f.seek(self._read_offset)
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # partial line mid-write; re-read next refresh
                self._read_offset += len(raw)
                line = raw.decode("utf-8").strip()
                if not line:
                    continue
                record = json.loads(line)
                key = self._key(record)
                if record.get("kind") == "static":
                    self._static[key] = record
                else:
                    self._updates.setdefault(key, []).append(record)
                n += 1
        return n

    def _persist(self, record: dict):
        data = json.dumps(record) + "\n"
        self._fh.write(data)
        self._fh.flush()
        # our own writes need no re-ingest on refresh()
        self._read_offset += len(data.encode("utf-8"))

    def close(self):
        self._fh.close()


__all__ = ["StatsStorageEvent", "BaseStatsStorage", "InMemoryStatsStorage",
           "FileStatsStorage"]
