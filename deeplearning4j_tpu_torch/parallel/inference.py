"""Parallel inference on one device (counterpart of
``deeplearning4j_tpu/parallel/inference.py``).

Dynamic batching keeps the JAX package's shape: requests enqueue as
observables on a BOUNDED queue; a background worker coalesces up to
``batch_limit`` requests (waiting at most ``queue_timeout_ms`` for
stragglers) into ONE forward on the device, padded to the bucket ladder
(``perf/bucketing.BucketPolicy``), and hands each request its rows.
``inference_mode="sequential"`` dispatches each request on the caller's
thread instead. Requests are taken as float32, token ids ``(rows, t)`` for
a model that starts with an embedding included (exact below 2**24).
Answers are host arrays (numpy), as in the JAX package: a dispatch copies
its output to the host once.

Requests past their deadline are evicted at batch formation
(:class:`DeadlineExpiredError`); a queue that stays full raises
:class:`QueueFullError` at ``submit``. ``warmup(example, buckets)``
dispatches every bucket of the ladder once before traffic (on the card
that builds and loads the kernels and sizes PyTorch's allocator);
``stats()["unwarmed_dispatches"]`` counts live dispatches at a size the
warm-up never ran, which a warmed server keeps at 0.

``fold_bn=True`` serves the BN-folded network (``perf.fusion.fold_bn``);
``quantize=`` a ``quant.CalibrationRecord`` serves the integer lowering
(``quant.quantize``, BN-folded first) with ``weight_bits`` 8 or 4 (the
int4 dense layers run the ``int4_dot`` kernel).

**Checkpoint hot-swap.** ``start_hot_swap(checkpoint_manager)`` (or
``checkpoint_manager=`` at construction) serves a training job's newer
commits: :meth:`poll_checkpoint` restores the newest checkpoint OFF the
dispatch path, re-applies the same fold or quantize record, checks that
the tree has the serving model's structure, waits for the card to finish
building it, and then swaps the whole parameter and state tree in under
the dispatch lock — no request is dropped and no dispatch sees a mix of
old and new weights. A torn newest checkpoint, from which the manager falls
back to an older one, neither re-swaps nor downgrades.

Only the worker thread (or, in sequential mode, the caller) dispatches to
the card, and each thread that does selects the card first.

``mesh=`` takes a one-rank ``parallel.make_mesh()`` and serves on its
device; a mesh of several ranks raises ``MultiRankMeshError`` (each rank
serves on its own device: the JAX package shards one dispatch over its
mesh, the port runs one ``ParallelInference`` a rank).

A ``ComputationGraph`` with one network output is served as a
``MultiLayerNetwork`` is (its output comes to the host once a dispatch).

``tuning=`` takes an autotuner ``TuningRecord`` (``perf/autotune.py``;
None inherits the model's ``_tuning_record``, restored from a zip or a
checkpoint): it is verified against the model's architecture
(``StaleTuningRecordError`` names a mismatch), its bucket ladder becomes
the default bucket policy, and the ladder is warmed at construction from
a zero example of the configuration's input shape
(:meth:`_tuning_example`), so live traffic dispatches only warmed sizes.
``stats()["tuning"]`` reports it. The model's ``compile_watch`` counts the
dispatches and first-seen shapes (``stats()["model_compiles"]``).
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from collections import Counter, deque
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.perf.bucketing import BucketPolicy, pad_to_bucket, unpad

log = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """The bounded request queue stayed full past the admission timeout. A
    serving front-end maps this to HTTP 429."""


class DeadlineExpiredError(TimeoutError):
    """The request's deadline passed before its batch dispatched. A serving
    front-end maps this to HTTP 504."""


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


def select_device(device: torch.device):
    """Make ``device`` the calling thread's current card (a no-op on the
    CPU): every thread that dispatches to the card calls this first."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


def tree_signature(tree):
    """Structure, shapes and dtypes of a parameter or state tree: two trees
    with equal signatures can replace each other under a served model."""
    if isinstance(tree, dict):
        return tuple((k, tree_signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(tree_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype))
    return type(tree).__name__


class ParallelInference:
    """``output()`` for synchronous calls; ``submit()`` /
    ``output_batched()`` for the dynamic-batching path.

    ``model`` must live on ``device`` (the port's device rule: ``cuda``
    unless ``device="cpu"``); it is never moved. ``bucket_policy``:
    canonical dispatch sizes (default: powers of two, floor 8); ``None``
    dispatches every batch at its own size."""

    _DEFAULT_POLICY = object()
    _SENTINEL = object()

    def __init__(self, model, mesh=None, batch_limit: int = 32,
                 queue_timeout_ms: float = 5, inference_mode: str = "batched",
                 bucket_policy=_DEFAULT_POLICY,
                 batch_size_history: int = 1024, fold_bn: bool = False,
                 quantize=None, weight_bits: int = 8, checkpoint_manager=None,
                 checkpoint_poll_secs: Optional[float] = None,
                 queue_depth: int = 1024, queue_put_timeout_ms: float = 50.0,
                 tuning=None, device=None):
        if mesh is not None:
            # a mesh of one rank names this process's device; a mesh of
            # several raises (each rank serves on its own device)
            from deeplearning4j_tpu_torch.parallel.mesh import local_device_of
            device = local_device_of(mesh, device, "ParallelInference")
        if inference_mode not in ("batched", "sequential"):
            raise ValueError(f"unknown inference_mode '{inference_mode}'")
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
        if model.params is None:
            model.init()
        # a record restored with the model rides along unless overridden;
        # it is checked against the raw conf it was searched on, before
        # folding or quantizing rebuild the model
        self._tuning = tuning = (tuning if tuning is not None
                                 else getattr(model, "_tuning_record", None))
        if tuning is not None:
            from deeplearning4j_tpu_torch.perf.autotune import verify_tuning
            from deeplearning4j_tpu_torch.perf.kernels import check_kernels_flag
            verify_tuning(model.conf, tuning)
            check_kernels_flag(tuning.pallas_kernels, self.device)
            if bucket_policy is ParallelInference._DEFAULT_POLICY and tuning.buckets:
                bucket_policy = BucketPolicy(buckets=tuning.buckets)
        self._fold_bn = bool(fold_bn)
        self._quantize = quantize
        self._weight_bits = int(weight_bits)
        # provenance is read BEFORE folding/quantizing, which build new
        # networks without it: losing it would make the first hot-swap poll
        # re-swap the very checkpoint this server already serves
        restored_from = getattr(model, "_restored_from", None)
        model = self._lower(model)
        from deeplearning4j_tpu_torch.quant.lowering import is_quantized
        self.quantized = is_quantized(model)
        self.model = model
        self.batch_limit = batch_limit
        self.queue_timeout_ms = queue_timeout_ms
        self.inference_mode = inference_mode
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
        # bounded windows: sustained serving must not grow host memory.
        # batch_sizes counts coalesced REQUESTS, row_sizes pre-pad ROWS
        self.batch_sizes: "deque" = deque(maxlen=max(1, batch_size_history))
        self.row_sizes: "deque" = deque(maxlen=max(1, batch_size_history))
        self.bucket_dispatches: Counter = Counter()
        self.unwarmed_dispatches = 0
        self._warmed: set = set()
        self._stats_lock = threading.Lock()
        # serializes dispatches against each other and against hot swaps:
        # a swap waits for the in-flight batch, the next one sees new params
        self._model_lock = threading.Lock()
        self._swap_cm = None
        self._swap_thread: Optional[threading.Thread] = None
        self._swap_stop = threading.Event()
        self.swaps = 0
        self.swap_poll_errors = 0
        # poll backoff under a broken store (utils/backoff.py), seeded per
        # instance as in the JAX package
        self._swap_backoff_rng = random.Random(0xD14)
        self.swap_consecutive_errors = 0
        self.swap_last_poll_delay: Optional[float] = None
        self.current_checkpoint_step = (None if restored_from is None
                                        else int(restored_from.step))
        from deeplearning4j_tpu_torch.obs.registry import (absorb_inference_stats,
                                                           get_registry)
        from deeplearning4j_tpu_torch.obs.trace import get_tracer
        self._tracer = get_tracer()
        reg = get_registry()
        self._m_queue_depth = reg.gauge(
            "serving_queue_depth", unit="requests",
            help="requests waiting in the batching queue after a coalesce")
        self._m_occupancy = reg.histogram(
            "serving_batch_occupancy", unit="requests",
            help="coalesced requests per dispatched batch (batch_limit is "
                 "the ceiling)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_pad_waste = reg.histogram(
            "serving_pad_waste_rows", unit="rows",
            help="padding rows added per dispatch to reach the bucket "
                 "target (bucket ladder pad waste)",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
        absorb_inference_stats(reg, self)
        if tuning is not None and tuning.buckets:
            # warm the RECORDED ladder now; a model whose input shape the
            # conf does not pin (several inputs, no sequence length) warms
            # on first traffic
            ex = self._tuning_example()
            if ex is not None:
                self.warmup(ex, buckets=tuning.buckets)
        if checkpoint_manager is not None:
            self.start_hot_swap(checkpoint_manager, poll_secs=checkpoint_poll_secs)

    def _tuning_example(self) -> Optional[np.ndarray]:
        """A zero example of the configuration's input shape (one row),
        for warming the TuningRecord's ladder; None when the conf does not
        pin a single input shape."""
        conf = self.model.conf
        it = getattr(conf, "input_type", None)
        if it is None:
            its = getattr(conf, "input_types", None) or ()
            if len(its) != 1:
                return None
            it = its[0]
        if it is None:
            return None
        if it.kind in ("rnn", "cnn1d") and it.timeseries_length is None:
            return None  # no canonical length to warm at
        try:
            shape = it.example_shape(1)
        except ValueError:
            return None
        return np.zeros(shape, np.float32)

    def _lower(self, model):
        """The serving graph of ``model``: quantized (BN-folded first) or
        BN-folded as this server was configured. Hot swaps apply it anew."""
        if self._quantize is not None:
            from deeplearning4j_tpu_torch.quant import quantize as _quantize_net
            return _quantize_net(model, self._quantize, weight_bits=self._weight_bits)
        if self._fold_bn:
            from deeplearning4j_tpu_torch.perf.fusion import fold_bn as _fold_bn
            return _fold_bn(model)
        return model

    # --------------------------------------------------------- shape policy
    def _pad_target(self, n: int) -> int:
        if self.bucket_policy is None or n < 1:
            return n
        return self.bucket_policy.bucket(n)

    def _record_dispatch_shape(self, target: int, n_rows: int):
        with self._stats_lock:
            self.bucket_dispatches[target] += 1
            self.row_sizes.append(n_rows)
            if target not in self._warmed:
                self.unwarmed_dispatches += 1
        self._m_pad_waste.observe(max(0, target - n_rows))

    def _dispatch(self, arr, target: int, record: bool = True) -> np.ndarray:
        """Pad to EXACTLY ``target`` rows, run the model, copy the real rows
        to the host: the one choke point of device dispatches, warm-up and
        live traffic alike. ``record=False`` (warm-up) keeps the dispatch
        out of the serving counters."""
        select_device(self.device)
        x = torch.as_tensor(np.asarray(arr, np.float32), device=self.device)
        n = x.shape[0]
        x = pad_to_bucket(x, target)
        if record:
            self._record_dispatch_shape(target, n)
        with self._tracer.span("serving.dispatch", rows=n, target=target):
            with self._model_lock:
                out = self.model.output(x)
            if isinstance(out, list):  # a ComputationGraph's outputs, on the host
                if len(out) != 1:
                    raise ValueError(f"ParallelInference serves one output; this graph has "
                                     f"{len(out)}")
                return unpad(out[0], n)
            return unpad(out, n).cpu().numpy()

    def output(self, x) -> np.ndarray:
        """Synchronous inference, padded to the bucket ladder."""
        arr = np.asarray(x, np.float32)
        return self._dispatch(arr, self._pad_target(arr.shape[0]))

    def warmup(self, example, buckets=None) -> List[int]:
        """Dispatch every bucket once BEFORE traffic arrives. ``example``
        has a leading batch axis; without ``buckets`` the ladder runs up to
        ``batch_limit`` requests of the example's size. Returns the warmed
        dispatch sizes."""
        ex = np.asarray(example)
        if ex.ndim < 1:
            raise ValueError("warmup example needs a leading batch axis")
        feat_shape = ex.shape[1:]
        if buckets is None:
            max_rows = max(1, self.batch_limit) * max(1, ex.shape[0])
            if self.bucket_policy is None:
                buckets = [max_rows]
            else:
                buckets = self.bucket_policy.buckets_up_to(max_rows)
        for b in sorted({int(b) for b in buckets}):
            target = self._pad_target(b)
            if target in self._warmed:
                continue
            self._dispatch(np.zeros((target,) + feat_shape, np.float32), target,
                           record=False)
            with self._stats_lock:
                self._warmed.add(target)
        with self._stats_lock:
            return sorted(self._warmed)

    def learned_bucket_policy(self, max_compiles: int = 8) -> BucketPolicy:
        """A ladder of at most ``max_compiles`` buckets learned from the
        recorded pre-pad row counts (``BucketPolicy.from_histogram``)."""
        with self._stats_lock:
            rows = [r for r in self.row_sizes if r >= 1]
        if not rows:
            raise ValueError(
                "no dispatches recorded yet — serve some traffic (or seed "
                "row_sizes) before learning a bucket ladder")
        return BucketPolicy.from_histogram(rows, max_compiles=max_compiles)

    # ------------------------------------------------- checkpoint hot-swap
    def start_hot_swap(self, checkpoint_manager, poll_secs: Optional[float] = None):
        """Watch ``checkpoint_manager``'s journal and swap newer commits in
        between dispatches. With ``poll_secs`` a daemon thread calls
        :meth:`poll_checkpoint` on that cadence; ``None`` polls by hand."""
        self._swap_cm = checkpoint_manager
        if poll_secs is not None and self._swap_thread is None:
            self._swap_stop.clear()
            self._swap_thread = threading.Thread(
                target=self._hot_swap_loop, args=(float(poll_secs),),
                name="ckpt-hot-swap", daemon=True)
            self._swap_thread.start()
        return self

    def stop_hot_swap(self):
        self._swap_stop.set()
        t, self._swap_thread = self._swap_thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _next_poll_delay(self, poll_secs: float, consecutive_errors: int,
                         cap_s: float = 30.0) -> float:
        """``poll_secs`` while healthy, plus a capped exponential backoff
        with jitter (``utils/backoff.py``) once the store errors."""
        if consecutive_errors <= 0:
            return poll_secs
        from deeplearning4j_tpu_torch.utils.backoff import backoff_delay
        return poll_secs + backoff_delay(consecutive_errors - 1,
                                         base_s=max(poll_secs, 0.05),
                                         cap_s=cap_s, rng=self._swap_backoff_rng)

    def _hot_swap_loop(self, poll_secs: float):
        delay = poll_secs
        while not self._swap_stop.wait(delay):
            try:
                self.poll_checkpoint()
                with self._stats_lock:
                    self.swap_consecutive_errors = 0
            except Exception:
                # the serving path outlives a broken store; the count is in
                # stats() for alerting
                with self._stats_lock:
                    self.swap_poll_errors += 1
                    self.swap_consecutive_errors += 1
                log.exception("checkpoint hot-swap poll failed; serving "
                              "continues on the current params")
            with self._stats_lock:
                delay = self._next_poll_delay(poll_secs, self.swap_consecutive_errors)
                self.swap_last_poll_delay = delay

    def poll_checkpoint(self) -> bool:
        """One probe: restore a newer committed checkpoint off the dispatch
        path, lower it as the served model was lowered, and swap its whole
        tree in between dispatches. Returns whether a swap happened."""
        cm = self._swap_cm
        if cm is None:
            return False
        select_device(self.device)
        cm.refresh()
        refresh_err = getattr(cm, "last_refresh_error", None)
        if refresh_err is not None:
            # the journal re-read failed: this probe learned nothing; the
            # poll loop counts the fault and backs off
            raise refresh_err
        step = cm.latest_step()
        if step is None or (self.current_checkpoint_step is not None
                            and step <= self.current_checkpoint_step):
            return False
        restored = cm.restore_latest(load_updater=False)
        if restored is None:
            return False
        # restore_latest may have fallen back past a torn newest entry to a
        # checkpoint at or before the one served: never re-swap or downgrade
        restored_step = restored._restored_from.step
        if self.current_checkpoint_step is not None \
                and restored_step <= self.current_checkpoint_step:
            return False
        if restored.device != self.device:
            restored = restored.to(self.device)
        restored = self._lower(restored)
        if (tree_signature(restored.params) != tree_signature(self.model.params)
                or tree_signature(restored.state) != tree_signature(self.model.state)):
            raise RuntimeError(
                "hot-swap checkpoint params have a different structure "
                "than the serving model — the store holds a different "
                "architecture; refusing to swap")
        new_params, new_state = restored.params, restored.state
        if self.device.type == "cuda":
            # the tree was built on this thread: every copy and kernel that
            # made it must be done before a dispatch can read it
            torch.cuda.synchronize(self.device)
        with self._model_lock:
            self.model.params = new_params
            self.model.state = new_state
        with self._stats_lock:
            self.swaps += 1
            self.current_checkpoint_step = int(restored_step)
        return True

    # ---------------------------------------------------------------- stats
    @staticmethod
    def _size_summary(sizes) -> dict:
        summary = {"count": len(sizes)}
        if sizes:
            summary.update(
                mean=round(float(np.mean(sizes)), 2),
                p50=float(np.percentile(sizes, 50)),
                p95=float(np.percentile(sizes, 95)),
                max=int(max(sizes)))
        return summary

    def stats(self) -> dict:
        """Request and dispatch counts, batch-size and row-count summaries
        over the retained window, per-bucket dispatch counts, warmed
        buckets, hot-swap state, queue counters and the attention path
        counters (counted process-wide by ``nn/conf/attention.py``)."""
        from deeplearning4j_tpu_torch.nn.conf.attention import counters
        with self._stats_lock:
            sizes = list(self.batch_sizes)
            rows = list(self.row_sizes)
            out = {
                "requests_served": self.requests_served,
                "batches_dispatched": self.batches_dispatched,
                "quantized": self.quantized,
                "queue": {"depth": self.queue_depth, "size": self._q.qsize(),
                          "rejected": self.queue_rejections,
                          "expired": self.deadline_evictions},
                "bucket_policy": (None if self.bucket_policy is None
                                  else repr(self.bucket_policy)),
                "tuning": {"applied": self._tuning is not None,
                           "buckets": (list(self._tuning.buckets)
                                       if self._tuning is not None else None)},
                "warmed_buckets": sorted(self._warmed),
                "bucket_dispatches": dict(self.bucket_dispatches),
                "unwarmed_dispatches": self.unwarmed_dispatches,
                "hot_swap": {
                    "enabled": self._swap_cm is not None,
                    "swaps": self.swaps,
                    "current_checkpoint_step": self.current_checkpoint_step,
                    "poll_errors": self.swap_poll_errors,
                    "consecutive_poll_errors": self.swap_consecutive_errors,
                    "last_poll_delay_s": (None if self.swap_last_poll_delay is None
                                          else round(self.swap_last_poll_delay, 4)),
                },
            }
        out["batch_size"] = self._size_summary(sizes)
        out["row_size"] = self._size_summary(rows)
        out["attention"] = dict(counters)
        cw = getattr(self.model, "compile_watch", None)
        if cw is not None:
            out["model_compiles"] = cw.compiles()
            out["model_dispatches"] = cw.dispatches()
            fus = cw.counters("fusion.")
            if fus:
                out["fusion"] = fus
        # the last analysis.trace_check report on this model, if one ran
        report = getattr(self.model, "last_trace_report", None)
        if report is not None:
            out["trace_hazards"] = report.counts()
        return out

    # -------------------------------------------------------- batched path
    def submit(self, x, deadline: Optional[float] = None) -> InferenceObservable:
        """Enqueue one request; returns its observable. ``deadline`` is an
        absolute ``time.monotonic()`` timestamp; an expired request is
        evicted before dispatch and its ``get()`` raises
        :class:`DeadlineExpiredError`. A queue that stays full for
        ``queue_put_timeout_ms`` raises :class:`QueueFullError`. In
        sequential mode the request dispatches on this thread."""
        obs = InferenceObservable()
        if self.inference_mode == "sequential":
            try:
                if deadline is not None and time.monotonic() >= deadline:
                    with self._stats_lock:
                        self.deadline_evictions += 1
                    raise DeadlineExpiredError("request deadline expired before dispatch")
                obs._resolve(self.output(np.asarray(x, np.float32)))
            except BaseException as e:  # surfaced at .get()
                obs._fail(e)
            with self._stats_lock:
                self.requests_served += 1
            return obs
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
                    f" after {self.queue_put_timeout_ms:g}ms — the worker "
                    "is not draining fast enough; shed load upstream")
            time.sleep(min(0.001, remaining))

    def output_batched(self, x) -> np.ndarray:
        """Blocking convenience over submit()."""
        return self.submit(x).get()

    def shutdown(self):
        """Stop the hot-swap poller and the worker after draining; pending
        observables are either served by the final drain or failed, never
        left hanging."""
        self.stop_hot_swap()
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
        select_device(self.device)
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
            self._m_queue_depth.set(self._q.qsize())
            self._m_occupancy.observe(len(items))
            sizes = [len(x) for x, _, _ in items]
            with self._inflight_lock:
                self._inflight = [obs for _, obs, _ in items]
            try:
                out = self.output(np.concatenate([x for x, _, _ in items], axis=0))
                ofs = 0
                for (_, obs, _), n in zip(items, sizes):
                    obs._resolve(out[ofs:ofs + n])
                    ofs += n
            except BaseException as e:  # every request of the batch sees it
                for _, obs, _ in items:
                    obs._fail(e)
            finally:
                with self._inflight_lock:
                    self._inflight = []
            with self._stats_lock:
                self.requests_served += len(items)
                self.batches_dispatched += 1
                self.batch_sizes.append(len(items))
