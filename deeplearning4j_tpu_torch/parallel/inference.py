"""Parallel inference on one device (counterpart of
``deeplearning4j_tpu/parallel/inference.py``).

Dynamic batching keeps the JAX package's shape: requests enqueue as
observables on a BOUNDED queue; a background worker coalesces up to
``batch_limit`` requests (waiting at most ``queue_timeout_ms`` for
stragglers) into ONE forward on the device, padded to the bucket ladder
(``perf/bucketing.BucketPolicy``), and hands each request its rows. Requests
are taken as float32, token ids ``(rows, t)`` for a model that starts with
an embedding included (exact below 2**24). Answers are host arrays (numpy),
as in the JAX package: the worker copies each batch's output to the host
once.

Requests past their deadline are evicted at batch formation
(:class:`DeadlineExpiredError`); a queue that stays full raises
:class:`QueueFullError` at ``submit``. ``fold_bn=True`` serves the
BN-folded network (``perf.fusion.fold_bn``). Mesh sharding, checkpoint
hot-swap, tuning records and the metrics registry come in later slices.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.perf.bucketing import BucketPolicy, pad_to_bucket, unpad


class QueueFullError(RuntimeError):
    """The bounded request queue stayed full past the admission timeout."""


class DeadlineExpiredError(TimeoutError):
    """The request's deadline passed before its batch dispatched."""


class InferenceObservable:
    """Per-request future."""

    def __init__(self):
        self._done = threading.Event()
        self._out = None
        self._err: Optional[BaseException] = None

    def _resolve(self, out):
        self._out = out
        self._done.set()

    def _fail(self, err: BaseException):
        self._err = err
        self._done.set()

    def is_done(self) -> bool:
        return self._done.is_set()

    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._err is not None:
            raise self._err
        return self._out


class ParallelInference:
    """``output()`` for synchronous calls; ``submit()`` /
    ``output_batched()`` for the dynamic-batching path, which coalesces
    concurrent requests on a worker thread.

    ``model`` must live on ``device`` (the port's device rule: ``cuda``
    unless ``device="cpu"``); it is never moved. ``bucket_policy``:
    canonical dispatch sizes (default: powers of two, floor 8); ``None``
    dispatches every batch at its own size."""

    _DEFAULT_POLICY = object()
    _SENTINEL = object()

    def __init__(self, model, batch_limit: int = 32,
                 queue_timeout_ms: float = 5, bucket_policy=_DEFAULT_POLICY,
                 queue_depth: int = 1024, queue_put_timeout_ms: float = 50.0,
                 device=None, fold_bn: bool = False):
        if int(queue_depth) < 1:
            raise ValueError(f"queue_depth must be >= 1; got {queue_depth}")
        if queue_put_timeout_ms < 0:
            raise ValueError("queue_put_timeout_ms must be >= 0")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"the model lives on {model.device}, not on {self.device}: "
                "build it there (or pass device=) — ParallelInference does "
                "not move models")
        from deeplearning4j_tpu_torch.quant.lowering import is_quantized
        if model.params is None:
            model.init()
        if fold_bn:
            from deeplearning4j_tpu_torch.perf.fusion import fold_bn as _fold_bn
            model = _fold_bn(model)
        self.model = model
        self.quantized = is_quantized(model)
        self.batch_limit = batch_limit
        self.queue_timeout_ms = queue_timeout_ms
        self.bucket_policy = (BucketPolicy()
                              if bucket_policy is ParallelInference._DEFAULT_POLICY
                              else bucket_policy)
        self.queue_depth = int(queue_depth)
        self.queue_put_timeout_ms = float(queue_put_timeout_ms)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self.queue_rejections = 0
        self.deadline_evictions = 0
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._stop = threading.Event()
        # observables the worker has dequeued but not yet resolved; shutdown
        # fails these too if the worker never comes back
        self._inflight: List[InferenceObservable] = []
        self._inflight_lock = threading.Lock()
        self.requests_served = 0
        self.batches_dispatched = 0
        self.bucket_dispatches: Counter = Counter()
        self._stats_lock = threading.Lock()
        # serializes forwards: output() may run on caller threads beside
        # the worker
        self._model_lock = threading.Lock()

    # --------------------------------------------------------- shape policy
    def _pad_target(self, n: int) -> int:
        if self.bucket_policy is None or n < 1:
            return n
        return self.bucket_policy.bucket(n)

    def _dispatch(self, arr, target: int) -> np.ndarray:
        """Pad to EXACTLY ``target`` rows, run the model, copy the real rows
        to the host."""
        x = torch.as_tensor(np.asarray(arr, np.float32), device=self.device)
        n = x.shape[0]
        x = pad_to_bucket(x, target)
        with self._stats_lock:
            self.bucket_dispatches[target] += 1
        with self._model_lock:
            out = self.model.output(x)
        return unpad(out, n).cpu().numpy()

    def output(self, x) -> np.ndarray:
        """Synchronous inference, padded to the bucket ladder."""
        arr = np.asarray(x, np.float32)
        return self._dispatch(arr, self._pad_target(arr.shape[0]))

    def stats(self) -> dict:
        """Request/dispatch counts, per-bucket dispatch counts, queue
        counters, and the attention path counters (``attention.flash`` /
        ``attention.dense`` calls, counted process-wide by
        ``nn/conf/attention.py``)."""
        from deeplearning4j_tpu_torch.nn.conf.attention import counters
        with self._stats_lock:
            return {
                "requests_served": self.requests_served,
                "batches_dispatched": self.batches_dispatched,
                "bucket_dispatches": dict(self.bucket_dispatches),
                "quantized": self.quantized,
                "queue": {"depth": self.queue_depth, "size": self._q.qsize(),
                          "rejected": self.queue_rejections,
                          "expired": self.deadline_evictions},
                "bucket_policy": (None if self.bucket_policy is None
                                  else repr(self.bucket_policy)),
                "attention": dict(counters),
            }

    # -------------------------------------------------------- batched path
    def submit(self, x, deadline: Optional[float] = None) -> InferenceObservable:
        """Enqueue one request; returns its observable. ``deadline`` is an
        absolute ``time.monotonic()`` timestamp; an expired request is
        evicted before dispatch and its ``get()`` raises
        :class:`DeadlineExpiredError`. A queue that stays full for
        ``queue_put_timeout_ms`` raises :class:`QueueFullError`."""
        obs = InferenceObservable()
        item = (np.asarray(x, np.float32), obs, deadline)
        give_up = time.monotonic() + self.queue_put_timeout_ms / 1000.0
        while True:
            # enqueue + worker liveness under ONE lock, so a concurrent
            # shutdown() can never strand this request
            with self._worker_lock:
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    pass
                else:
                    self._ensure_worker_locked()
                    return obs
            remaining = give_up - time.monotonic()
            if remaining <= 0:
                with self._stats_lock:
                    self.queue_rejections += 1
                raise QueueFullError(
                    f"request queue full (queue_depth={self.queue_depth})"
                    f" after {self.queue_put_timeout_ms:g}ms — shed load upstream")
            time.sleep(min(0.001, remaining))

    def output_batched(self, x) -> np.ndarray:
        """Blocking convenience over submit()."""
        return self.submit(x).get()

    def shutdown(self):
        """Stop the worker after draining; pending observables are either
        served by the final drain or failed, never left hanging."""
        with self._worker_lock:
            w = self._worker
            if w is not None and w.is_alive():
                self._stop.set()
                try:
                    self._q.put_nowait(ParallelInference._SENTINEL)
                except queue.Full:  # a full queue keeps it busy and re-checking _stop
                    pass
                w.join(timeout=10)
                if w.is_alive():
                    with self._inflight_lock:
                        stuck, self._inflight = self._inflight, []
                    for obs in stuck:
                        if not obs.is_done():
                            obs._fail(RuntimeError(
                                "ParallelInference worker did not stop within "
                                "10s at shutdown; in-flight request abandoned"))
            self._worker = None
            leftovers = []
            try:
                while True:
                    leftovers.append(self._q.get_nowait())
            except queue.Empty:
                pass
            for item in leftovers:
                if item is not ParallelInference._SENTINEL:
                    item[1]._fail(RuntimeError(
                        "ParallelInference shut down before request served"))

    # ------------------------------------------------------------- worker
    def _ensure_worker_locked(self):
        """Caller holds _worker_lock."""
        if self._worker is None or not self._worker.is_alive():
            self._stop.clear()
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="parallel-inference",
                                            daemon=True)
            self._worker.start()

    def _collect(self):
        """Take up to batch_limit requests, waiting queue_timeout_ms for
        stragglers after the first arrives."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        if first is ParallelInference._SENTINEL:
            return []
        items = [first]
        deadline = time.monotonic() + self.queue_timeout_ms / 1000.0
        while len(items) < self.batch_limit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is ParallelInference._SENTINEL:
                break
            items.append(nxt)
        return items

    def _worker_loop(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            now = time.monotonic()
            expired = [it for it in items if it[2] is not None and now >= it[2]]
            items = [it for it in items if it[2] is None or now < it[2]]
            if expired:
                # count BEFORE failing: a caller woken by get() must see
                # the eviction already reflected in stats()
                with self._stats_lock:
                    self.deadline_evictions += len(expired)
            for _, obs, dl in expired:
                obs._fail(DeadlineExpiredError(
                    f"request deadline expired {now - dl:.3f}s before "
                    "batch dispatch"))
            if not items:
                continue
            sizes = [len(x) for x, _, _ in items]
            with self._inflight_lock:
                self._inflight = [obs for _, obs, _ in items]
            try:
                out = self.output(np.concatenate([x for x, _, _ in items], axis=0))
                ofs = 0
                for (_, obs, _), n in zip(items, sizes):
                    obs._resolve(out[ofs:ofs + n])
                    ofs += n
            except Exception as e:  # every request of the batch sees it
                for _, obs, _ in items:
                    obs._fail(e)
            finally:
                with self._inflight_lock:
                    self._inflight = []
            with self._stats_lock:
                self.requests_served += len(items)
                self.batches_dispatched += 1
