"""Retrieval behind the serving tier: batched index endpoints with the
full overload contract (counterpart of
``deeplearning4j_tpu/retrieval/service.py``, with its obs registry hooks;
``serving.ModelServer.add_index`` serves it over HTTP).

:class:`IndexEndpoint` is to a vector index what ``ParallelInference``
is to a model: client threads ``submit()`` queries into a BOUNDED queue;
one worker thread coalesces whatever is queued into a single device
dispatch (continuous batching — cross-client queries share the kernel
launch), padded to the index's warmed pow2 bucket ladder with ``k``
rounded to a pow2 rung. The serving semantics are typed errors, with the
HTTP codes the JAX package's ``ModelServer`` maps them to:

- full queue         → ``QueueFullError``        → 429 + Retry-After
- expired deadline   → ``DeadlineExpiredError``  → 504 (evicted BEFORE
  device dispatch; a 200 always means the deadline was met)
- breaker open       → ``BreakerOpenError``      → 503 + Retry-After
- dispatch failure   → ``IndexDispatchError``    → 500 (feeds the
  breaker)

**Hot-swap rebuild**: ``swap_index(new_index)`` warms the replacement's
bucket ladder OFF the query path (on the card that builds and loads its
kernels and sizes the allocator), then swaps the reference under
``_swap_lock`` BETWEEN dispatches, so an index rebuilt from fresh
embeddings rolls out mid-burst with zero dropped queries and zero errors
on admitted requests.

Requests carry ``k`` per query; a coalesced batch dispatches at the
LARGEST k-rung present and every request slices its own ``k`` back out
— mixed-k traffic still shares one program per (bucket, rung) pair.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.parallel.inference import (DeadlineExpiredError,
                                                         InferenceObservable,
                                                         QueueFullError)
from deeplearning4j_tpu_torch.serving.breaker import (BreakerOpenError,
                                                      CircuitBreaker)

__all__ = ["IndexEndpoint", "IndexDispatchError"]


class IndexDispatchError(RuntimeError):
    """The device search itself failed (counted against the breaker)."""


class IndexEndpoint:
    """One served index: bounded admission, deadline-aware continuous
    batching, circuit breaker and hot-swap rebuild. Drive ``query()``
    (blocking) or ``submit()`` (an observable) directly."""

    def __init__(self, name: str, index, *, k_default: int = 10,
                 k_max: int = 128, default_deadline_ms: float = 1000.0,
                 queue_depth: int = 256, batch_limit: int = 64,
                 queue_timeout_ms: float = 2.0,
                 breaker: Optional[CircuitBreaker] = None,
                 warmup_queries: int = 256):
        self.name = name
        # the CONFIGURED limits survive swaps; the effective ones clamp
        # to what the live index can score per query (IVF caps at
        # nprobe·cap) — an admitted k must never fail in dispatch, where
        # it would read as a model fault and feed the breaker, and a
        # swap to a smaller index must not ratchet the limits down for
        # every later (bigger) index
        self._cfg_k_default = int(k_default)
        self._cfg_k_max = int(k_max)
        self.k_max = min(self._cfg_k_max, index.max_k)
        self.k_default = self._cfg_k_default
        if not 1 <= self.k_default <= self.k_max:
            raise ValueError(f"k_default={k_default} outside "
                             f"[1, k_max={self.k_max}]")
        self.default_deadline_ms = float(default_deadline_ms)
        self.batch_limit = int(batch_limit)
        self.queue_timeout_ms = float(queue_timeout_ms)
        self.warmup_queries = int(warmup_queries)
        # request batches are capped at the warmup ceiling (ValueError at
        # admission) and the worker stops coalescing at the same bound,
        # so no dispatch can land on an un-warmed query bucket
        self.max_query_rows = min(self.warmup_queries,
                                  self.batch_limit * 4)
        self._carry = None  # over-budget coalesce item held for the next batch
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.queue_depth = int(queue_depth)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._swap_lock = threading.Lock()  # index ref + device dispatch
        self._index = index
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.warmed = False
        self.warmed_pairs = []
        self.queries_served = 0
        self.batches_dispatched = 0
        self.queue_rejections = 0
        self.deadline_evictions = 0
        self.swaps = 0
        from deeplearning4j_tpu_torch.obs.registry import (absorb_index_endpoint,
                                                           get_registry)
        reg = get_registry()
        self._m_queries = reg.counter(
            "retrieval_queries", unit="requests",
            help="vector queries admitted into retrieval endpoints")
        self._m_query_ms = reg.histogram(
            "retrieval_query_ms", unit="ms",
            help="end-to-end retrieval query latency for admitted "
                 "requests (queue wait + batch formation + dispatch)")
        self._m_occupancy = reg.histogram(
            "retrieval_batch_occupancy", unit="requests",
            help="coalesced queries per dispatched retrieval batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        absorb_index_endpoint(reg, self)

    # -------------------------------------------------------------- index
    @property
    def index(self):
        # lock-free read: a reference load is atomic, and taking
        # _swap_lock here would make stats()/introspection block behind
        # an in-flight dispatch (the lock exists to serialize SWAPS
        # against dispatches, not reads)
        return self._index

    def _warm_ks(self, k_cap: int) -> tuple:
        """Every pow2 k-rung up to ``k_cap``: ``submit`` admits ANY k in
        [1, k_max], so warmup dispatches every rung it can map to."""
        ks, k = [], 1
        while k < k_cap:
            ks.append(k)
            k <<= 1
        ks.append(k_cap)
        return tuple(ks)

    def warmup(self) -> "IndexEndpoint":
        """Dispatch the full (query-bucket × k-rung) ladder once; flips
        readiness."""
        idx = self.index
        # the (bucket, k-rung) pairs dispatched, one device dispatch each
        self.warmed_pairs = idx.warmup(
            max_queries=self.max_query_rows,
            ks=self._warm_ks(min(self.k_max, idx.max_k)))
        self.warmed = True
        return self

    def swap_index(self, new_index, warm: bool = True) -> "IndexEndpoint":
        """Hot-swap a rebuilt index under load. The replacement warms on
        THIS thread first, then the reference swaps between dispatches —
        in-flight batches finish on the old index, the next batch serves
        the new one, nothing drops."""
        if new_index.dim != self._index.dim:
            raise ValueError(
                f"replacement index dim {new_index.dim} != serving dim "
                f"{self._index.dim} — clients would get shape 400s; "
                "register a new endpoint for a different embedding space")
        # limits re-derive from the CONFIGURED values, so a detour
        # through a small interim index does not permanently shrink them
        new_k_max = min(self._cfg_k_max, new_index.max_k)
        if warm:
            new_index.warmup(max_queries=self.max_query_rows,
                             ks=self._warm_ks(new_k_max))
        with self._swap_lock:
            self._index = new_index
            self.k_max = new_k_max
            self.k_default = min(self._cfg_k_default, new_k_max)
            self.swaps += 1
        return self

    # -------------------------------------------------------------- query
    def submit(self, q: np.ndarray, k: int,
               deadline: Optional[float] = None) -> InferenceObservable:
        """Enqueue one query batch; non-blocking full-queue semantics
        (immediate ``QueueFullError`` — serving sheds, never waits). A
        single ``(d,)`` vector is promoted to a one-row batch; malformed
        shapes raise ``ValueError`` HERE, synchronously — a caller error
        must never reach the worker, where it would fail the whole
        coalesced batch and count against the breaker."""
        if not 1 <= int(k) <= self.k_max:
            raise ValueError(f"k must be in [1, {self.k_max}]; got {k}")
        arr = np.asarray(q, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[0] < 1 \
                or arr.shape[1] != self._index.dim:
            raise ValueError(
                f"index '{self.name}' takes (b, {self._index.dim}) "
                f"queries; got shape {np.asarray(q).shape}")
        if arr.shape[0] > self.max_query_rows:
            raise ValueError(
                f"batch of {arr.shape[0]} queries exceeds this "
                f"endpoint's max_query_rows={self.max_query_rows} (the "
                "warmed-bucket ceiling = min(warmup_queries, "
                "batch_limit*4) — a bigger batch would land on an "
                "unwarmed bucket); split the batch, or raise whichever of "
                "warmup_queries/batch_limit is binding on the endpoint")
        obs = InferenceObservable()
        item = (arr, int(k), obs, deadline)
        with self._worker_lock:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                with self._stats_lock:
                    self.queue_rejections += 1
                raise QueueFullError(
                    f"retrieval queue full (queue_depth={self.queue_depth})"
                    " — the worker is not draining fast enough; shed load "
                    "upstream") from None
            self._ensure_worker_locked()
        self._m_queries.inc()
        return obs

    def query(self, queries, k: Optional[int] = None,
              deadline_ms: Optional[float] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Admission → deadline-aware batch formation → dispatch; returns
        ``(indices, distances)``. Raises the typed errors an HTTP layer
        maps to 429/503/504/500."""
        if not self.breaker.allow():
            raise BreakerOpenError(self.breaker.retry_after())
        kk = self.k_default if k is None else int(k)
        dl_ms = (self.default_deadline_ms if deadline_ms is None
                 else float(deadline_ms))
        deadline = (time.monotonic() + dl_ms / 1000.0
                    if dl_ms and dl_ms > 0 else None)
        t0 = time.perf_counter()
        obs = self.submit(queries, kk, deadline=deadline)
        try:
            out = obs.get(timeout=(dl_ms / 1000.0 + 5.0)
                          if deadline is not None else None)
        except DeadlineExpiredError:
            raise
        except TimeoutError:
            raise DeadlineExpiredError(
                "result not ready within deadline (+5s dispatch slack)")
        except BaseException as e:
            self.breaker.record_failure()
            raise IndexDispatchError(f"{type(e).__name__}: {e}") from e
        self.breaker.record_success()
        self._m_query_ms.observe((time.perf_counter() - t0) * 1e3)
        if deadline is not None and time.monotonic() > deadline:
            # completed late (batch already on device when the deadline
            # passed): 504, so a 200 ALWAYS means the deadline was met
            raise DeadlineExpiredError("result completed after the "
                                       "deadline; discarded")
        return out

    # -------------------------------------------------------------- worker
    def _ensure_worker_locked(self):
        if self._worker is None or not self._worker.is_alive():
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"retrieval-{self.name}")
            self._worker.start()

    _SENTINEL = object()

    def _collect(self) -> List:
        first, self._carry = self._carry, None
        if first is None:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                return []
            if first is IndexEndpoint._SENTINEL:
                return []
        items = [first]
        rows = len(first[0])
        deadline = time.monotonic() + self.queue_timeout_ms / 1000.0
        while len(items) < self.batch_limit and rows < self.max_query_rows:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is IndexEndpoint._SENTINEL:
                break
            if rows + len(nxt[0]) > self.max_query_rows:
                # coalescing past the warmed-bucket ceiling would land on
                # an unwarmed bucket; hold it for the NEXT batch instead
                self._carry = nxt
                break
            items.append(nxt)
            rows += len(nxt[0])
        return items

    def _worker_loop(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            # deadline eviction at batch formation — BEFORE device
            # dispatch, so an expired query never occupies a batch slot
            now = time.monotonic()
            expired = [it for it in items
                       if it[3] is not None and now >= it[3]]
            items = [it for it in items
                     if it[3] is None or now < it[3]]
            if expired:
                with self._stats_lock:
                    self.deadline_evictions += len(expired)
            for _, _, obs, dl in expired:
                obs._fail(DeadlineExpiredError(
                    f"query deadline expired {now - dl:.3f}s before "
                    "batch dispatch"))
            if not items:
                continue
            self._m_occupancy.observe(len(items))
            xs = [it[0] for it in items]
            sizes = [len(x) for x in xs]
            kmax = max(it[1] for it in items)
            try:
                with self._swap_lock:
                    # one coalesced dispatch at the largest k present;
                    # a swap waits here and the NEXT batch serves the
                    # new index — never a mid-batch mix. k is clamped to
                    # the LIVE index's per-query capacity: a swap to a
                    # smaller index must not 500 already-admitted
                    # requests (the hot-swap zero-non-200 contract)
                    k_eff = min(kmax, self._index.max_k)
                    idx, dist = self._index.search(
                        np.concatenate(xs, axis=0), k_eff)
                ofs = 0
                for (x, kk, obs, _), n in zip(items, sizes):
                    ki = min(kk, k_eff)
                    part_i, part_d = (idx[ofs:ofs + n, :ki],
                                      dist[ofs:ofs + n, :ki])
                    if ki < kk:
                        # index shrank under a swap: fill the tail with
                        # the standard padding answer (-1 @ inf), same
                        # contract as k exceeding probed candidates
                        part_i = np.concatenate(
                            [part_i, np.full((n, kk - ki), -1,
                                             part_i.dtype)], axis=1)
                        part_d = np.concatenate(
                            [part_d, np.full((n, kk - ki), np.inf,
                                             part_d.dtype)], axis=1)
                    obs._resolve((part_i, part_d))
                    ofs += n
            except BaseException as e:
                for _, _, obs, _ in items:
                    obs._fail(e)
            with self._stats_lock:
                self.queries_served += len(items)
                self.batches_dispatched += 1

    def shutdown(self):
        """Stop the worker; anything still queued is failed, never left
        hanging."""
        with self._worker_lock:
            w = self._worker
            if w is not None and w.is_alive():
                self._stop.set()
                try:
                    self._q.put_nowait(IndexEndpoint._SENTINEL)
                except queue.Full:
                    pass
                w.join(timeout=10)
            self._worker = None
            leftovers = []
            if self._carry is not None:
                leftovers.append(self._carry)
                self._carry = None
            try:
                while True:
                    leftovers.append(self._q.get_nowait())
            except queue.Empty:
                pass
            for item in leftovers:
                if item is not IndexEndpoint._SENTINEL:
                    item[2]._fail(RuntimeError(
                        "retrieval endpoint shut down before query served"))

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            st = {
                "queries_served": self.queries_served,
                "batches_dispatched": self.batches_dispatched,
                "queue": {"depth": self._q.qsize(),
                          "size": self.queue_depth,
                          "rejected": self.queue_rejections,
                          "expired": self.deadline_evictions},
                "swaps": self.swaps,
            }
        st.update({
            "warmed": self.warmed,
            "k_default": self.k_default, "k_max": self.k_max,
            "max_query_rows": self.max_query_rows,
            "default_deadline_ms": self.default_deadline_ms,
            "breaker": self.breaker.as_dict(),
            "index": self.index.stats(),
        })
        return st
