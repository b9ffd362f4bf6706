"""Remote stats routing: POST training stats to a (possibly remote) UI server
(counterpart of ``deeplearning4j_tpu/storage/remote.py``).

Parity surface: reference
``deeplearning4j-core/.../api/storage/impl/RemoteUIStatsStorageRouter.java:32``
(async posting to ``http://host:port/remoteReceive`` with bounded retries)
and the Play server's remote-receiver route. The receiving side is
``ui/server.py``'s ``POST /remoteReceive`` endpoint feeding the attached
storage.
"""

from __future__ import annotations

import json
import logging
import queue
import random
import threading
import time
import urllib.request
from typing import Optional

from deeplearning4j_tpu_torch.utils.backoff import backoff_delay

log = logging.getLogger(__name__)

DEFAULT_PATH = "remoteReceive"


class RemoteUIStatsStorageRouter:
    """Same write surface as a StatsStorage (put_static_info/put_update) but
    records travel over HTTP to a UI server process — use it as the
    ``storage`` of a StatsListener on training workers.

    Retries use capped exponential backoff with jitter
    (utils/backoff.py, the same policy checkpoint storage retries use):
    ``retry_backoff_s`` is the base, ``max_backoff_s`` the cap. The old
    linear ``base * (attempt + 1)`` schedule synchronized every worker's
    retries against a recovering UI server into periodic load spikes."""

    _END = object()

    def __init__(self, url: str, max_retries: int = 10,
                 retry_backoff_s: float = 0.5, max_backoff_s: float = 15.0,
                 queue_size: int = 256, seed: Optional[int] = None):
        self.base = url.rstrip("/")
        if not self.base.endswith("/" + DEFAULT_PATH):
            self.base = f"{self.base}/{DEFAULT_PATH}"
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_backoff_s = max_backoff_s
        self._rng = random.Random(seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._shutdown = False
        self._failures = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- router API
    def put_static_info(self, record: dict):
        self._enqueue(record)

    def put_update(self, record: dict):
        self._enqueue(record)

    def _enqueue(self, record: dict):
        if self._shutdown:
            raise RuntimeError("Router is shut down")
        try:
            self._q.put_nowait(record)
        except queue.Full:
            log.warning("RemoteUIStatsStorageRouter queue full; dropping a "
                        "stats record")

    def shutdown(self, timeout: float = 10.0) -> bool:
        """Stop the posting thread, attempting to flush first. During
        shutdown each remaining record gets ONE quick post attempt (2s
        timeout) instead of the full retry budget. Returns True when every
        queued record was delivered; False if records were dropped."""
        self._shutdown = True
        # a FULL queue used to mean the _END sentinel was silently dropped
        # and the worker only noticed shutdown via its 0.25s poll timeout —
        # and only after the queue went briefly empty. Keep offering the
        # sentinel while the worker drains: the first slot it frees takes
        # it, so exit is prompt and deterministic instead of racing the
        # poll loop.
        deadline = time.monotonic() + timeout
        enqueued = False
        while not enqueued and self._thread.is_alive():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                self._q.put(self._END, timeout=min(0.05, remaining))
                enqueued = True
            except queue.Full:
                continue
        self._thread.join(max(0.0, deadline - time.monotonic()))
        flushed = self._q.empty() and not self._thread.is_alive()
        if not flushed:
            log.warning("RemoteUIStatsStorageRouter shutdown before the "
                        "queue drained; undelivered stats records dropped")
        return flushed

    # --------------------------------------------------------------- worker
    def _worker(self):
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._shutdown:
                    return  # drained (or the _END marker never fit)
                continue
            if item is self._END:
                return
            body = json.dumps(item).encode("utf-8")
            # draining during shutdown: one quick attempt per record so the
            # caller's join() window actually bounds the flush
            retries = 1 if self._shutdown else self.max_retries
            req_timeout = 2 if self._shutdown else 10
            for attempt in range(retries):
                try:
                    req = urllib.request.Request(
                        self.base, data=body,
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=req_timeout) as resp:
                        resp.read()
                    self._failures = 0
                    break
                except Exception as e:
                    self._failures += 1
                    if attempt == retries - 1:
                        log.warning("Dropping stats record after %d failed "
                                    "posts to %s (%s)", retries,
                                    self.base, e)
                    else:
                        time.sleep(backoff_delay(
                            attempt, base_s=self.retry_backoff_s,
                            cap_s=self.max_backoff_s, rng=self._rng))
