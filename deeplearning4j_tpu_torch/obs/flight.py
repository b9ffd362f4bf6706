"""Crash flight recorder: a bounded ring of recent spans/events, flushed
to storage when the process is about to die (counterpart of
``deeplearning4j_tpu/obs/flight.py``, the same dump format).

The question a post-mortem needs answered is *what was the victim doing in
its last seconds*. The recorder keeps the answer cheap to maintain (a
``deque(maxlen=...)`` append per span/event) and flushes it as one JSON
object (``flightrec-<worker_id>``) through the same ``StorageBackend``
the checkpoints ride.

Flush sites (best-effort — a dying process must not die harder because
telemetry failed): ``FaultInjector._kill`` (checkpoint/faults.py), before
the simulated crash, ``kill_mode="process"``'s real SIGKILL included.
``train_until`` (checkpoint/resume.py) attaches the ring's tail to its
``CrashRecord``.

The recorder registers itself as a tracer sink (spans/events flow in when
tracing is enabled) and also accepts direct ``record()`` calls for
lifecycle breadcrumbs that must land even with tracing off.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import List, Optional

log = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "install_flight_recorder",
           "get_flight_recorder", "uninstall_flight_recorder",
           "flush_flight_recorder", "read_dumps", "latest_dump",
           "dump_tail_summary", "FLIGHT_PREFIX"]

#: storage object-name prefix every dump is written under
FLIGHT_PREFIX = "flightrec-"


def _summarize(rec: dict) -> str:
    attrs = rec.get("attrs") or {}
    extra = (" " + " ".join(f"{k}={v}" for k, v in attrs.items())
             if attrs else "")
    if rec.get("kind") == "span":
        return f"span {rec.get('name')} {rec.get('dur_ms', 0)}ms{extra}"
    return f"event {rec.get('name')}{extra}"


class FlightRecorder:
    """See module docstring. Usable directly as a tracer sink
    (``tracer.add_sink(recorder)`` — it is callable)."""

    def __init__(self, capacity: int = 512, store=None,
                 worker_id: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.worker_id = str(worker_id) if worker_id is not None else "local"
        self._store = None
        if store is not None:
            from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
            self._store = as_backend(store)
        self.recorded = 0
        self.flushes = 0

    # -------------------------------------------------------------- record
    def record(self, rec: dict):
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    __call__ = record  # tracer-sink protocol

    def event(self, name: str, **attrs):
        """Direct lifecycle breadcrumb (lands even with tracing off)."""
        self.record({"kind": "event", "name": name, "wall": time.time(),
                     "dur_ms": 0.0, "attrs": attrs})

    def tail(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-n:]

    def tail_summary(self, n: int = 8) -> List[str]:
        """Human-readable one-liners of the newest ``n`` ring entries —
        the shape attached to ``CrashRecord.flight_tail``."""
        return [_summarize(r) for r in self.tail(n)]

    # --------------------------------------------------------------- flush
    def flush(self, reason: str, store=None) -> Optional[str]:
        """Write the ring as one JSON object; returns the object name or
        None when there is no store / the write failed (logged, never
        raised — flushing happens on a dying path)."""
        backend = self._store
        if store is not None:
            from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
            backend = as_backend(store)
        if backend is None:
            log.warning("flight recorder flush (%s) dropped: no store",
                        reason)
            return None
        dump = {"worker_id": self.worker_id, "reason": str(reason),
                "time": time.time(), "events": self.tail()}
        name = f"{FLIGHT_PREFIX}{self.worker_id}"
        try:
            backend.put(name, json.dumps(dump).encode())
            self.flushes += 1
            return name
        except Exception as e:
            log.warning("flight recorder flush (%s) failed (%s: %s)",
                        reason, type(e).__name__, e)
            return None


# ---------------------------------------------------------- global default
_global_lock = threading.Lock()
_global: Optional[FlightRecorder] = None


def install_flight_recorder(store=None, worker_id: Optional[str] = None,
                            capacity: int = 512,
                            tracer=None) -> FlightRecorder:
    """Create the process-wide recorder and hook it into the (given or
    global) tracer as a sink. Replaces any previously installed one
    (unhooking it from the tracer)."""
    from deeplearning4j_tpu_torch.obs.trace import get_tracer
    global _global
    t = tracer if tracer is not None else get_tracer()
    with _global_lock:
        if _global is not None:
            t.remove_sink(_global)
        _global = FlightRecorder(capacity=capacity, store=store,
                                 worker_id=worker_id)
        t.add_sink(_global)
        return _global


def get_flight_recorder() -> Optional[FlightRecorder]:
    with _global_lock:
        return _global


def uninstall_flight_recorder(tracer=None):
    from deeplearning4j_tpu_torch.obs.trace import get_tracer
    global _global
    t = tracer if tracer is not None else get_tracer()
    with _global_lock:
        if _global is not None:
            t.remove_sink(_global)
        _global = None


def flush_flight_recorder(reason: str) -> Optional[str]:
    """Flush the installed recorder, if any — the one-liner the crash
    paths call. No-op (returns None) when nothing is installed."""
    fr = get_flight_recorder()
    if fr is None:
        return None
    return fr.flush(reason)


# ----------------------------------------------------- supervisor-side read
def read_dumps(store) -> List[dict]:
    """Every parseable flight dump in ``store``, oldest flush first by the
    dump's own timestamp."""
    from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
    backend = as_backend(store)
    out = []
    for name in backend.list(prefix=FLIGHT_PREFIX):
        try:
            out.append(json.loads(backend.get(name).decode()))
        except Exception as e:
            log.warning("unreadable flight dump %s (%s: %s)", name,
                        type(e).__name__, e)
    out.sort(key=lambda d: d.get("time", 0.0))
    return out


def latest_dump(store) -> Optional[dict]:
    dumps = read_dumps(store)
    return dumps[-1] if dumps else None


def dump_tail_summary(dump: dict, n: int = 8) -> List[str]:
    """The newest ``n`` entries of a flushed dump as one-liners, prefixed
    with the flush reason — what ``CrashRecord.flight_tail`` carries."""
    events = dump.get("events") or []
    lines = [_summarize(r) for r in events[-n:]]
    reason = dump.get("reason", "?")
    worker = dump.get("worker_id", "?")
    return [f"[{worker}] flushed: {reason}"] + lines
