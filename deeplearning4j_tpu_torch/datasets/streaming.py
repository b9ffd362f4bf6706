"""Streaming batch ingestion: push-driven DataSet iterators (counterpart
of ``deeplearning4j_tpu/datasets/streaming.py``; reference dl4j-streaming,
``CamelKafkaRouteBuilder.java:1``, where records arriving over Kafka feed a
training loop).

An external producer pushes batches into a live ``fit()``. A bounded
queue decouples the producer from the training loop, so the training
thread blocks only when the feed runs dry and the producer blocks while the
queue is full. :class:`StreamingHttpReceiver` is a minimal HTTP front door
(``POST /push`` with an ``.npz`` body, ``POST /end``) for producers in
other processes; its Content-Length is checked before the body is read
(``utils/http.py``). Batches arrive as host arrays; ``fit`` stages them on
the network's device as it stages any iterator's (``prefetch=True``
overlaps the copy with the step before).
"""

from __future__ import annotations

import io
import queue
import threading
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

__all__ = ["StreamingDataSetIterator", "StreamingHttpReceiver"]


class StreamingDataSetIterator(DataSetIterator):
    """Push-driven iterator of unbounded duration.

    Producers call :meth:`push` (from any thread) with a DataSet or
    (features, labels) arrays; the consumer is an ordinary DataSetIterator
    for ``net.fit``. Iteration blocks waiting for batches and ends when a
    producer calls :meth:`end` (one fit pass is one stream segment; a later
    iteration consumes the next segment from the same live queue), or when
    ``poll_timeout`` seconds pass with no batch."""

    _END = object()

    def __init__(self, queue_size: int = 16, poll_timeout: Optional[float] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._poll_timeout = poll_timeout
        self.pushed = 0
        self.consumed = 0
        self._bs: Optional[int] = None

    def push(self, features, labels=None, features_mask=None, labels_mask=None,
             timeout: Optional[float] = None):
        """Enqueue one batch; blocks while the queue is full (backpressure)."""
        if isinstance(features, DataSet):
            ds = features
        else:
            ds = DataSet(np.asarray(features), None if labels is None else np.asarray(labels),
                         features_mask=features_mask, labels_mask=labels_mask)
        self._q.put(ds, timeout=timeout)
        if self._bs is None:
            self._bs = int(ds.features.shape[0])
        self.pushed += 1
        return self

    def end(self):
        """End the current segment: the consuming iteration finishes once
        everything queued before this call is drained."""
        self._q.put(StreamingDataSetIterator._END)
        return self

    def _generate(self):
        while True:
            try:
                item = self._q.get(timeout=self._poll_timeout)
            except queue.Empty:
                return  # poll_timeout elapsed with no producer activity
            if item is StreamingDataSetIterator._END:
                return
            self.consumed += 1
            yield item

    def reset(self):  # a stream has no rewind
        pass

    def batch_size(self):
        return self._bs or 0


class StreamingHttpReceiver:
    """HTTP front door of a :class:`StreamingDataSetIterator` on
    ``127.0.0.1:port`` (0 picks a free port, read back from ``.port``).

    ``POST /push`` with an ``.npz`` body holding ``features`` and optional
    ``labels`` / ``features_mask`` / ``labels_mask`` enqueues one batch;
    ``POST /end`` ends the current segment. A missing or bad Content-Length
    is 400, one above ``max_body_bytes`` 413, an unreadable body 400."""

    def __init__(self, iterator: StreamingDataSetIterator, port: int = 0,
                 max_body_bytes: int = 1 << 30):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from deeplearning4j_tpu_torch.utils.http import parse_content_length
        it = iterator

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                try:
                    if self.path == "/end":
                        it.end()
                        self._ok(b"ended")
                        return
                    if self.path != "/push":
                        self.send_error(404)
                        return
                    n, err = parse_content_length(self.headers, max_body_bytes)
                    if err is not None:
                        self.send_error(*err)
                        return
                    with np.load(io.BytesIO(self.rfile.read(n))) as z:
                        it.push(z["features"], z["labels"] if "labels" in z else None,
                                z["features_mask"] if "features_mask" in z else None,
                                z["labels_mask"] if "labels_mask" in z else None)
                    self._ok(b"ok")
                except Exception as e:  # surface to the producer
                    self.send_error(400, str(e))

            def _ok(self, body):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()
