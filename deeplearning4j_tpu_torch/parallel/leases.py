"""Storage-backed TTL leases (counterpart of
``deeplearning4j_tpu/parallel/leases.py``), the membership primitive of
the elastic trainer (``parallel/elastic.py``).

- A participant owns one store object ``<prefix><id>`` holding a JSON
  record ``{worker_id, incarnation, seq, time, barrier, ...payload}``,
  refreshed by a daemon heartbeat thread every ``heartbeat_s`` (default
  ttl/3). Liveness = the record's wall timestamp is within ``ttl_s`` of
  the OBSERVER's clock (``clock=`` injectable for skew tests).
- ``payload`` extends the record: static fields set via
  :meth:`LeaseBoard.set_payload` plus a live ``payload_fn`` sampled at
  every write. A payload sampler that raises is counted and logged, never
  fatal.
- Store faults during a heartbeat are survivable until the TTL.

The records are the JAX package's JSON byte for byte (the same keys in
the same order), so a fleet of either package reads the other's leases.
Readers use :meth:`read_all` / :meth:`live`; a clean exit
:meth:`withdraw`s so peers need not wait out a TTL.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)

LEASE_PREFIX = "lease-"

__all__ = ["LEASE_PREFIX", "LeaseBoard"]


class LeaseBoard:
    """Per-participant heartbeat leases in the store.

    A lease is ``<prefix><worker_id>`` holding ``{worker_id, incarnation,
    seq, time, barrier}`` plus any payload fields; a background thread
    refreshes it every ``heartbeat_s`` (default ttl/3). ``barrier`` is the
    generation an elastic worker is ready to join — the rendezvous settles
    when every LIVE lease has either reached the barrier or expired. The
    fleet ignores ``barrier`` and rides the payload instead."""

    def __init__(self, store, worker_id: str, ttl_s: float = 10.0,
                 heartbeat_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time,
                 prefix: str = LEASE_PREFIX,
                 payload_fn: Optional[Callable[[], dict]] = None):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self.store = as_backend(store)
        self.worker_id = str(worker_id)
        self.ttl_s = float(ttl_s)
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s is not None
                            else self.ttl_s / 3.0)
        self.clock = clock
        self.prefix = str(prefix)
        self.payload_fn = payload_fn
        self.incarnation = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._payload: dict = {}
        self._barrier_gen = 0
        self._seq = 0
        self._last_write = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.heartbeat_errors = 0
        self.payload_errors = 0
        self.read_errors = 0

    # ------------------------------------------------------------- writing
    def set_payload(self, **fields):
        """Merge static fields into every subsequent lease write (e.g. a
        replica's address and placement). Does not write by itself — call
        :meth:`write` to publish immediately."""
        with self._lock:
            self._payload.update(fields)

    def write(self, barrier: Optional[int] = None):
        """Write this worker's lease now (also what the heartbeat thread
        calls). ``barrier`` updates the joined-generation marker."""
        extra = {}
        if self.payload_fn is not None:
            try:
                extra = dict(self.payload_fn())
            except Exception as e:
                self.payload_errors += 1
                log.warning("lease payload sampler for %s failed (%s: %s)",
                            self.worker_id, type(e).__name__, e)
        with self._lock:
            if barrier is not None:
                self._barrier_gen = int(barrier)
            self._seq += 1
            rec = dict(self._payload)
            rec.update(extra)
            rec.update({"worker_id": self.worker_id,
                        "incarnation": self.incarnation,
                        "seq": self._seq,
                        "time": self.clock(),
                        "barrier": self._barrier_gen})
        self.store.put(self.prefix + self.worker_id,
                       json.dumps(rec).encode())
        self._last_write = self.clock()

    def refresh_if_due(self):
        """Heartbeat inline when no beat landed for a heartbeat interval
        — keeps a worker alive through long WAITS (the rendezvous poll
        loop) even when the background thread isn't running."""
        if self.clock() - self._last_write >= self.heartbeat_s:
            self.write()

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def beat():
            while not self._stop.wait(self.heartbeat_s):
                try:
                    self.write()
                except Exception as e:
                    # a missed beat is survivable until the TTL; chaos
                    # tests inject faults here deliberately
                    self.heartbeat_errors += 1
                    log.warning("lease heartbeat for %s failed (%s: %s)",
                                self.worker_id, type(e).__name__, e)
        self._thread = threading.Thread(
            target=beat, name=f"lease-{self.worker_id}", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.heartbeat_s * 2 + 1)
            self._thread = None

    # ------------------------------------------------------------- reading
    def read_all(self) -> Dict[str, dict]:
        """Every parseable lease in the store, by worker id.

        A lease that cannot be fetched or parsed counts as absent (=
        expired) for THIS scan rather than failing the whole membership
        view — over a cloud backend one transient fault on one key must
        not make every peer look dead. ``read_errors`` counts the skips
        so persistent corruption stays visible."""
        out = {}
        for name in self.store.list(prefix=self.prefix):
            try:
                rec = json.loads(self.store.get(name).decode())
                out[str(rec["worker_id"])] = rec
            except Exception as e:
                self.read_errors += 1
                log.warning("unreadable lease %s (%s: %s)", name,
                            type(e).__name__, e)
        return out

    def is_fresh(self, rec: dict, now: Optional[float] = None) -> bool:
        now = self.clock() if now is None else now
        return (now - float(rec.get("time", 0))) <= self.ttl_s

    def live(self, leases: Optional[Dict[str, dict]] = None) -> Dict[str, dict]:
        leases = self.read_all() if leases is None else leases
        now = self.clock()
        return {w: r for w, r in leases.items() if self.is_fresh(r, now)}

    def withdraw(self):
        """Delete this worker's lease (clean exit — peers need not wait a
        TTL to notice)."""
        try:
            self.store.delete(self.prefix + self.worker_id)
        except Exception as e:
            log.warning("lease withdraw for %s failed (%s: %s)",
                        self.worker_id, type(e).__name__, e)
