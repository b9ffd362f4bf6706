"""Exporters: Prometheus text format + a JSONL event log over StorageBackend
(counterpart of ``deeplearning4j_tpu/obs/exporters.py``, the same text for
the same registry contents).

- :func:`prometheus_text` renders a ``MetricsRegistry`` in the Prometheus
  exposition format (``# HELP`` / ``# TYPE``, ``_bucket{le=...}`` /
  ``_sum`` / ``_count`` for histograms).
- :class:`EventLog` is a tracer sink writing span/event records as JSON
  lines through any ``checkpoint.storage.StorageBackend``. Storage puts
  are whole-object-atomic (no append), so the log accumulates lines in
  memory and rewrites its object on flush — readers always see a complete
  prefix of the stream, never a torn line.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
from typing import Deque, List, Optional

from deeplearning4j_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                             MetricsRegistry, get_registry)

log = logging.getLogger(__name__)

__all__ = ["prometheus_text", "EventLog", "read_event_log"]


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render ``registry`` (default: the process-wide one) in the
    Prometheus text exposition format, units folded into the HELP line."""
    reg = registry if registry is not None else get_registry()
    lines: List[str] = []
    for m in reg.collect():
        help_text = f"{m.help} [unit: {m.unit}]".replace("\\", "\\\\") \
            .replace("\n", " ")
        lines.append(f"# HELP {m.name} {help_text}")
        if isinstance(m, Counter):
            lines.append(f"# TYPE {m.name} counter")
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {m.name} gauge")
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {m.name} histogram")
            cum = 0
            counts = m.bucket_counts()
            for bound, c in zip(m.bounds, counts):
                cum += c
                lines.append(f'{m.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{m.name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{m.name}_sum {_fmt(m.sum)}")
            lines.append(f"{m.name}_count {m.count}")
    return "\n".join(lines) + "\n"


class EventLog:
    """JSONL span/event log through a ``StorageBackend`` (see module
    docstring). Callable, so it plugs straight in as a tracer sink::

        elog = EventLog(backend, name="events-w0.jsonl")
        get_tracer().add_sink(elog)

    ``flush_every`` bounds how many records can be lost to a crash (the
    flight recorder covers the final seconds regardless); ``max_records``
    bounds memory under sustained runs by dropping the OLDEST lines (the
    drop is counted and logged once). Threshold-triggered flushes run on
    a background daemon thread so the emitting (training/serving) thread
    never blocks on a storage rewrite; an explicit ``flush()``/``close()``
    is synchronous and returns only once the object is durable."""

    def __init__(self, store, name: str = "events.jsonl",
                 flush_every: int = 64, max_records: int = 100_000):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self._store = as_backend(store)
        self.name = str(name)
        self.flush_every = max(1, int(flush_every))
        self.max_records = max(1, int(max_records))
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        # deque(maxlen=...) drops the oldest line in O(1) — a plain list's
        # del [0] would shift max_records pointers on every emit once full
        self._lines: Deque[str] = collections.deque(maxlen=self.max_records)
        self._unflushed = 0
        self._flush_pending = False
        self.dropped = 0
        self.emitted = 0

    def emit(self, record: dict):
        try:
            line = json.dumps(record)
        except (TypeError, ValueError) as e:
            log.debug("unserializable event dropped (%s: %s)",
                      type(e).__name__, e)
            return
        flush_due = False
        with self._lock:
            full = len(self._lines) == self.max_records
            self._lines.append(line)
            self.emitted += 1
            if full:
                self.dropped += 1
                if self.dropped == 1:
                    log.warning("event log %s hit max_records=%d — oldest "
                                "records now drop", self.name,
                                self.max_records)
            self._unflushed += 1
            if self._unflushed >= self.flush_every:
                flush_due = True
        if flush_due:
            self._request_flush()

    __call__ = emit  # tracer-sink protocol

    def _request_flush(self):
        """Run a flush on a short-lived daemon thread, coalesced: at most
        one background flush in flight (flush snapshots EVERY retained
        line, so records arriving meanwhile are covered by the next one).
        Keeps whole-object rewrites — which grow with the log and may sit
        through storage retry budgets — off the emitting hot path."""
        with self._lock:
            if self._flush_pending:
                return
            self._flush_pending = True

        def _bg():
            try:
                self.flush()
            finally:
                with self._lock:
                    self._flush_pending = False
                    # records that crossed the threshold while this flush
                    # held the store (their trigger was coalesced away)
                    # must not wait for a future emit that may never come
                    rearm = self._unflushed >= self.flush_every
            if rearm:
                self._request_flush()

        threading.Thread(target=_bg, name=f"eventlog-flush-{self.name}",
                         daemon=True).start()

    def flush(self) -> bool:
        """Rewrite the log object with every retained line. Returns False
        (logged, not raised) on storage failure. ``_flush_lock`` serializes
        whole flushes — snapshot + put — so a slow flusher can never
        overwrite a newer snapshot with an older one (``_lock`` alone only
        covers the snapshot, and emit must not block on storage)."""
        with self._flush_lock:
            with self._lock:
                data = ("\n".join(self._lines) + "\n") if self._lines else ""
                self._unflushed = 0
            try:
                self._store.put(self.name, data.encode())
                return True
            except Exception as e:
                log.warning("event log flush to %s failed (%s: %s)",
                            self.name, type(e).__name__, e)
                return False

    def close(self):
        self.flush()


def read_event_log(store, name: str) -> List[dict]:
    """Parse a flushed JSONL event log back into records (skipping
    unparseable lines — a reader must survive a torn tail)."""
    from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
    out = []
    for line in as_backend(store).get(name).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out
