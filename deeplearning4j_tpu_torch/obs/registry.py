"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms
(counterpart of ``deeplearning4j_tpu/obs/registry.py``: the same
instruments, quantile estimates and names, so the same observations give
the same p50/p95/p99 and the same Prometheus text in both packages).

- every instrument is registered **with a unit and help text**, so a
  Prometheus scrape or a post-mortem report is self-describing;
- instruments are process-wide singletons by name: two subsystems asking
  for ``checkpoint_commit_ms`` share one histogram, exactly like a
  Prometheus client registry;
- **histograms are fixed-bucket** (default: an exponential millisecond
  ladder) with p50/p95/p99 estimated by linear interpolation inside the
  bucket — bounded memory under sustained serving, no reservoir;
- live sources that keep their own counters (a ``CheckpointManager``, a
  ``ParallelInference``, a compile counter) are *absorbed* through
  collect-time callbacks (:func:`absorb_checkpoint_manager` and friends),
  so scraping pulls their current values without hot-path writes. The
  absorbers are duck-typed: they read the attributes and ``stats()`` keys
  named in each one, whichever package's object holds them.

Everything here is host-side plain Python (dict/ints under a lock).
Instrument mutation methods never raise on well-typed input and are safe
from any thread. Unlike the JAX package's, the default registry starts with
no callback: the port has no process-wide compile counter to absorb.
"""

from __future__ import annotations

import logging
import re
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger(__name__)

__all__ = [
    "MetricError", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "absorb_compile_watch", "absorb_training_stats",
    "watch_training_stats",
    "absorb_inference_stats", "absorb_checkpoint_manager",
    "absorb_model_server", "absorb_index_endpoint", "watch_grad_compression",
    "publish_stats_update", "DEFAULT_BUCKETS_MS",
]


class MetricError(ValueError):
    """Bad metric registration: invalid name, missing unit/help text, or a
    name re-registered as a different instrument kind."""


_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: default histogram bucket upper bounds — an exponential ladder in
#: milliseconds spanning sub-ms dispatches to minute-scale restores
DEFAULT_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0, 60000.0)


class _Instrument:
    kind = "instrument"

    def __init__(self, name: str, unit: str, help: str):
        self.name = name
        self.unit = unit
        self.help = help
        self._lock = threading.Lock()

    def as_dict(self) -> dict:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count (requests served, bytes written)."""

    kind = "counter"

    def __init__(self, name, unit, help):
        super().__init__(name, unit, help)
        self._value = 0.0

    def inc(self, by: float = 1.0):
        if by < 0:
            raise ValueError(f"counter '{self.name}' cannot decrease")
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def as_dict(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "value": self.value}


class Gauge(_Instrument):
    """Point-in-time value (queue depth, current generation id)."""

    kind = "gauge"

    def __init__(self, name, unit, help):
        super().__init__(name, unit, help)
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, by: float = 1.0):
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def as_dict(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "value": self.value}


class Histogram(_Instrument):
    """Fixed-bucket histogram with quantile estimation.

    ``buckets`` are upper bounds (an implicit +Inf bucket is appended).
    Quantiles interpolate linearly inside the winning bucket; the +Inf
    bucket reports the maximum observed value. Bounded memory: only the
    per-bucket counts and min/max/sum are retained."""

    kind = "histogram"

    def __init__(self, name, unit, help,
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        super().__init__(name, unit, help)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise MetricError(f"histogram '{name}' needs at least 1 bucket")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            i = 0
            for i, b in enumerate(self.bounds):
                if v <= b:
                    break
            else:
                i = len(self.bounds)
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the bucket counts."""
        with self._lock:
            if self._count == 0:
                return 0.0
            target = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else min(self._min, 0.0)
                    hi = self.bounds[i] if i < len(self.bounds) else self._max
                    frac = (target - cum) / c
                    est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    # the estimate interpolates to the bucket EDGE; the
                    # observed extremes bound what actually happened
                    return max(self._min, min(self._max, est))
                cum += c
            return self._max

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def as_dict(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if count else 0.0
            mx = self._max if count else 0.0
        return {"kind": self.kind, "unit": self.unit, "help": self.help,
                "count": count, "sum": round(total, 3),
                "mean": round(total / count, 3) if count else 0.0,
                "min": round(mn, 3), "max": round(mx, 3),
                "p50": round(self.quantile(0.50), 3),
                "p95": round(self.quantile(0.95), 3),
                "p99": round(self.quantile(0.99), 3)}


class MetricsRegistry:
    """Named instruments + collect-time callbacks (see module docstring).

    Registration is idempotent by (name, kind): asking again returns the
    existing instrument; asking for the same name as a DIFFERENT kind
    raises :class:`MetricError`. Units and help text are mandatory and
    non-empty — an unlabeled number on a dashboard is a guess."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Instrument] = {}
        self._callbacks: List[Callable[["MetricsRegistry"], None]] = []

    # --------------------------------------------------------- registration
    def _register(self, cls, name: str, unit: str, help: str, **kw):
        if not _NAME_RE.match(name or ""):
            raise MetricError(
                f"invalid metric name {name!r}: must match "
                f"{_NAME_RE.pattern} (lowercase, underscores)")
        if not isinstance(unit, str) or not unit.strip():
            raise MetricError(f"metric '{name}' needs a non-empty unit")
        if not isinstance(help, str) or not help.strip():
            raise MetricError(f"metric '{name}' needs non-empty help text")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise MetricError(
                        f"metric '{name}' already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            inst = cls(name, unit, help, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, unit: str, help: str) -> Counter:
        return self._register(Counter, name, unit, help)

    def gauge(self, name: str, unit: str, help: str) -> Gauge:
        return self._register(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str, help: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> Histogram:
        return self._register(Histogram, name, unit, help, buckets=buckets)

    # -------------------------------------------------------------- queries
    def metric(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def register_callback(self, cb: Callable[["MetricsRegistry"], None]):
        """Run ``cb(registry)`` at every :meth:`collect` — the pull-based
        bridge for live sources that keep their own counters. Callback
        errors are swallowed (observability must never break a scrape)."""
        with self._lock:
            self._callbacks.append(cb)

    def unregister_callback(self, cb):
        with self._lock:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    def collect(self) -> List[_Instrument]:
        """Run callbacks, then return every instrument sorted by name."""
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb(self)
            except Exception as e:
                log.warning("metrics collect callback failed (%s: %s)",
                            type(e).__name__, e)
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def as_dict(self) -> Dict[str, dict]:
        return {m.name: m.as_dict() for m in self.collect()}

    def clear(self):
        """Drop every instrument and callback (tests only — live code holds
        instrument references that would silently detach)."""
        with self._lock:
            self._metrics.clear()
            self._callbacks.clear()


# ------------------------------------------------------------ global default
_global_lock = threading.Lock()
_global: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide default registry, created on first use."""
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
        return _global


def _sanitize(name: str) -> str:
    s = re.sub(r"[^a-z0-9_]", "_", str(name).lower()).strip("_")
    return s if s and s[0].isalpha() else f"m_{s}"


# ------------------------------------------------------------ absorb bridges
def absorb_compile_watch(registry: MetricsRegistry, watch=None):
    """Pull a compile counter into gauges: total compiles/dispatches plus
    every freeform counter (e.g. ``fusion.fused_block``). ``watch`` is
    anything with ``compiles()``, ``dispatches()`` and ``counters()``: a
    network's or an index's ``compile_watch``, ``perf.compile_watch.GLOBAL``
    or the JAX package's ``CompileWatch``. The gauges keep the JAX
    package's names and help text, so both packages' scrapes read alike.
    ``None`` reads the process-wide ``GLOBAL`` watch."""
    if watch is None:
        from deeplearning4j_tpu_torch.perf.compile_watch import GLOBAL as watch
    w = watch
    registry.gauge("jit_compiles", unit="compiles",
                   help="cumulative XLA compiles seen by CompileWatch"
                   ).set(w.compiles())
    registry.gauge("jit_dispatches", unit="dispatches",
                   help="cumulative jitted dispatches seen by CompileWatch"
                   ).set(w.dispatches())
    for key, val in w.counters().items():
        registry.gauge(f"jit_{_sanitize(key)}", unit="events",
                       help=f"CompileWatch freeform counter '{key}'"
                       ).set(val)


def absorb_training_stats(registry: MetricsRegistry, stats,
                          prefix: str = "train_phase"):
    """Pull a ``parallel.stats.TrainingStats`` into gauges: per-phase total
    and mean milliseconds, example/minibatch totals, and its freeform
    counters (model compiles, trace-hazard counts, ...)."""
    registry.gauge(f"{prefix}_examples", unit="examples",
                   help="examples consumed (TrainingStats)"
                   ).set(stats.examples)
    registry.gauge(f"{prefix}_minibatches", unit="batches",
                   help="minibatches consumed (TrainingStats)"
                   ).set(stats.minibatches)
    for phase in stats.key_set():
        ds = stats.get_value(phase)
        p = _sanitize(phase)
        registry.gauge(f"{prefix}_{p}_total_ms", unit="ms",
                       help=f"total wall time in training phase '{phase}'"
                       ).set(sum(ds) * 1000.0)
        registry.gauge(f"{prefix}_{p}_mean_ms", unit="ms",
                       help=f"mean wall time of training phase '{phase}'"
                       ).set(sum(ds) / len(ds) * 1000.0 if ds else 0.0)
    for name, val in stats.counters.items():
        registry.gauge(f"{prefix}_{_sanitize(name)}", unit="events",
                       help=f"TrainingStats counter '{name}'").set(val)


def watch_training_stats(registry: MetricsRegistry, stats,
                         prefix: str = "train_phase"):
    """Register a collect-time callback running ``absorb_training_stats``
    on a live ``TrainingStats``, so every scrape carries its current phase
    timings. Weakref'd + self-removing like the serving and checkpoint
    absorbers (last-registered stats wins the shared gauge names)."""
    ref = weakref.ref(stats)

    def _cb(reg: MetricsRegistry):
        live = ref()
        if live is None:
            reg.unregister_callback(_cb)
            return
        absorb_training_stats(reg, live, prefix=prefix)

    registry.register_callback(_cb)
    return _cb


def absorb_inference_stats(registry: MetricsRegistry, pi):
    """Register a collect-time callback pulling a ``ParallelInference``'s
    ``stats()`` sections — request/dispatch totals, hot-swap state, bucket
    dispatch counts, attention/fusion kernel-path counters — into gauges.
    Holds only a weakref; once the server is collected the callback
    removes itself at the next scrape. The gauge names are process-wide:
    with SEVERAL live servers the last-registered one wins per scrape
    (one serving process per model server is the deployment shape; a
    multi-model tier needs per-instance naming on top)."""
    ref = weakref.ref(pi)

    def _cb(reg: MetricsRegistry):
        live = ref()
        if live is None:
            reg.unregister_callback(_cb)
            return
        st = live.stats()
        reg.gauge("serving_requests", unit="requests",
                  help="requests served by ParallelInference"
                  ).set(st["requests_served"])
        reg.gauge("serving_batches_dispatched", unit="batches",
                  help="coalesced batches dispatched by ParallelInference"
                  ).set(st["batches_dispatched"])
        reg.gauge("serving_unwarmed_dispatches", unit="dispatches",
                  help="dispatches at a bucket size never warmed up"
                  ).set(st["unwarmed_dispatches"])
        q = st["queue"]
        reg.gauge("serving_queue_bound", unit="requests",
                  help="configured bound of the admission queue "
                       "(queue_depth)").set(q["depth"])
        reg.gauge("serving_queue_rejected", unit="requests",
                  help="submits rejected with QueueFullError by the "
                       "bounded admission queue").set(q["rejected"])
        reg.gauge("serving_deadline_evictions", unit="requests",
                  help="requests evicted at batch formation because their "
                       "deadline expired before dispatch").set(q["expired"])
        hs = st["hot_swap"]
        reg.gauge("serving_hot_swap_swaps", unit="swaps",
                  help="checkpoint hot-swaps applied to the serving model"
                  ).set(hs["swaps"])
        reg.gauge("serving_hot_swap_poll_errors", unit="errors",
                  help="failed checkpoint hot-swap polls (store faults)"
                  ).set(hs["poll_errors"])
        if hs["current_checkpoint_step"] is not None:
            reg.gauge("serving_checkpoint_step", unit="steps",
                      help="training step of the checkpoint being served"
                      ).set(hs["current_checkpoint_step"])
        for bucket, n in st["bucket_dispatches"].items():
            reg.gauge(f"serving_bucket_{int(bucket)}_dispatches",
                      unit="dispatches",
                      help=f"dispatches padded to bucket size {bucket}"
                      ).set(n)
        for section in ("attention", "fusion"):
            for key, val in st.get(section, {}).items():
                reg.gauge(f"serving_{_sanitize(key)}", unit="events",
                          help=f"model kernel-path counter '{key}'").set(val)

    registry.register_callback(_cb)
    return _cb


def absorb_index_endpoint(registry: MetricsRegistry, ep):
    """Register a collect-time callback pulling a retrieval
    ``IndexEndpoint``'s stats — query/batch totals, queue pressure,
    hot-swap rebuild count, index size/bytes and the per-index
    CompileWatch — into gauges. Weakref'd + self-removing like the other
    absorbers; the endpoint's hot-path counters (retrieval_queries,
    retrieval_query_ms) are live registry instruments already. The gauge
    names are process-wide: with SEVERAL live index endpoints the
    last-registered one wins per scrape (the ``absorb_inference_stats``
    caveat — one headline index per serving process is the deployment
    shape; a multi-index tier wanting per-index scrape granularity reads
    ``GET /v1/indexes`` stats instead)."""
    ref = weakref.ref(ep)

    def _cb(reg: MetricsRegistry):
        live = ref()
        if live is None:
            reg.unregister_callback(_cb)
            return
        st = live.stats()
        reg.gauge("retrieval_queries_served", unit="requests",
                  help="vector queries answered by the retrieval endpoint"
                  ).set(st["queries_served"])
        reg.gauge("retrieval_batches_dispatched", unit="batches",
                  help="coalesced device dispatches by the retrieval "
                       "endpoint").set(st["batches_dispatched"])
        reg.gauge("retrieval_queue_rejected", unit="requests",
                  help="queries shed by the bounded retrieval admission "
                       "queue (QueueFullError -> 429)"
                  ).set(st["queue"]["rejected"])
        reg.gauge("retrieval_deadline_evictions", unit="requests",
                  help="queries evicted at batch formation because their "
                       "deadline expired before dispatch (504)"
                  ).set(st["queue"]["expired"])
        reg.gauge("retrieval_index_swaps", unit="swaps",
                  help="hot-swap index rebuilds applied under load"
                  ).set(st["swaps"])
        ix = st["index"]
        reg.gauge("retrieval_index_vectors", unit="vectors",
                  help="vectors resident in the served index"
                  ).set(ix["size"])
        reg.gauge("retrieval_index_bytes", unit="bytes",
                  help="device-resident bytes of the served index "
                       "(memory_bytes(): the HBM residency scraped next "
                       "to the planner's numbers — int8/int4/PQ "
                       "compression shows up here)"
                  ).set(ix.get("memory_bytes", ix["nbytes"]))
        if ix.get("pq_distortion") is not None:
            reg.gauge("retrieval_pq_distortion", unit="mse",
                      help="mean squared PQ reconstruction error per "
                           "vector of the served index's codebooks "
                           "(rises when fresh embeddings drift from the "
                           "trained codebooks — the rebuild signal)"
                      ).set(ix["pq_distortion"])
        if "compile_watch" in ix:
            reg.gauge("retrieval_index_compiles", unit="compiles",
                      help="XLA compiles triggered by the served index's "
                           "scoring kernels (should be flat after warmup)"
                      ).set(ix["compile_watch"]["compiles"])

    registry.register_callback(_cb)
    return _cb


def absorb_model_server(registry: MetricsRegistry, server):
    """Register a collect-time callback pulling a ``serving.ModelServer``'s
    drain state and per-endpoint breaker aggregates into gauges. Weakref'd
    + self-removing like the other absorbers (the server's own counters —
    shed/expired/request_ms — are live registry instruments already; this
    bridge covers the derived/aggregate state)."""
    ref = weakref.ref(server)

    def _cb(reg: MetricsRegistry):
        live = ref()
        if live is None:
            reg.unregister_callback(_cb)
            return
        reg.gauge("serving_models", unit="models",
                  help="models registered on the serving front-end"
                  ).set(len(live.endpoints))
        reg.gauge("serving_draining", unit="bool",
                  help="1 while the server drains (new arrivals shed, "
                       "in-flight completing)").set(1.0 if live.draining
                                                   else 0.0)
        reg.gauge("serving_ready", unit="bool",
                  help="1 when every endpoint is warmed and the server "
                       "is not draining (/readyz)"
                  ).set(1.0 if live.readiness()[0] else 0.0)
        breakers = [ep.breaker for ep in live.endpoints.values()]
        reg.gauge("serving_breakers_open", unit="breakers",
                  help="endpoints whose circuit breaker is currently not "
                       "closed (open or half-open)"
                  ).set(sum(1 for b in breakers
                            if b.state != "closed"))
        reg.gauge("serving_breaker_opens", unit="events",
                  help="cumulative breaker open transitions across all "
                       "endpoints").set(sum(b.opens for b in breakers))

    registry.register_callback(_cb)
    return _cb


def watch_grad_compression(registry: MetricsRegistry, model):
    """Register a collect-time callback pulling a compressed model's
    device-resident accounting state (parallel/compress.py) into the
    registry: compression ratio + residual-norm gauges and cumulative
    dense/wire bytes-on-wire counters. The device scalars are fetched at
    SCRAPE time only — never on the step path, which stays sync-free.
    Weakref'd + self-removing like the other absorbers; counter deltas are
    tracked per callback so the process-wide counters count only bytes
    accumulated while THIS callback watched — ``_cb.reseed()``
    re-baselines the delta tracking at the
    restored accumulator values so a kill-and-resume never re-counts the
    pre-crash history."""
    ref = weakref.ref(model)
    seen = {"dense": 0.0, "wire": 0.0}

    def _read(st):
        """Fetch every device scalar into plain floats BEFORE touching any
        instrument, so a scrape never exports a torn read."""
        acc = {k: float(v) for k, v in st["acc"].items()}
        ctrl = st.get("ctrl") or {}
        tau = float(ctrl["tau"]) if "tau" in ctrl else None
        return acc, tau

    def _cb(reg: MetricsRegistry):
        live = ref()
        if live is None:
            reg.unregister_callback(_cb)
            return
        # a scrape racing a step can catch the old tree mid-replacement —
        # re-read the fresh attribute, and skip this scrape under a
        # sustained storm
        for _ in range(3):
            st = getattr(live, "compress_state", None)
            if st is None:
                return
            try:
                acc, tau = _read(st)
                break
            except RuntimeError:
                continue
        else:
            return
        reg.gauge("grad_compress_ratio", unit="x",
                  help="dense/compressed bytes-on-wire ratio of the last "
                       "compressed training step").set(acc["last_ratio"])
        reg.gauge("grad_compress_steps", unit="steps",
                  help="training steps that ran the compressed gradient "
                       "collective").set(acc["steps"])
        reg.gauge("grad_residual_norm", unit="l2",
                  help="global L2 norm of the error-feedback residual "
                       "after the last compressed step"
                  ).set(acc["residual_norm"])
        if tau is not None:
            reg.gauge("grad_compress_threshold", unit="magnitude",
                      help="current adaptive threshold tau of the "
                           "ThresholdCompression controller").set(tau)
        dense_c = reg.counter(
            "grad_compress_bytes_dense_total", unit="bytes",
            help="cumulative bytes a DENSE f32 gradient all-reduce would "
                 "have moved per participant")
        wire_c = reg.counter(
            "grad_compress_bytes_wire_total", unit="bytes",
            help="cumulative estimated bytes-on-wire of the compressed "
                 "gradient representation per participant")
        dense_c.inc(max(0.0, acc["dense_bytes"] - seen["dense"]))
        wire_c.inc(max(0.0, acc["wire_bytes"] - seen["wire"]))
        seen["dense"] = max(seen["dense"], acc["dense_bytes"])
        seen["wire"] = max(seen["wire"], acc["wire_bytes"])

    def _reseed():
        live = ref()
        st = getattr(live, "compress_state", None) if live is not None \
            else None
        if st is None:
            return
        try:
            acc, _ = _read(st)
        except RuntimeError:
            return
        seen["dense"] = acc["dense_bytes"]
        seen["wire"] = acc["wire_bytes"]

    _cb.reseed = _reseed
    registry.register_callback(_cb)
    return _cb


def absorb_checkpoint_manager(registry: MetricsRegistry, cm):
    """Register a collect-time callback pulling a ``CheckpointManager``'s
    save counters — and, when its storage is a ``RetryingBackend``, the
    retry/give-up counts — into gauges. Weakref'd + self-removing like
    the serving one (last-registered manager wins the shared names)."""
    ref = weakref.ref(cm)

    def _cb(reg: MetricsRegistry):
        live = ref()
        if live is None:
            reg.unregister_callback(_cb)
            return
        reg.gauge("checkpoint_saves_requested", unit="saves",
                  help="checkpoint saves requested on this manager"
                  ).set(live.saves_requested)
        reg.gauge("checkpoint_saves_committed", unit="saves",
                  help="checkpoint saves journaled durably"
                  ).set(live.saves_committed)
        reg.gauge("checkpoint_saves_fenced", unit="saves",
                  help="checkpoint saves dropped by the model fence"
                  ).set(live.saves_fenced)
        storage = getattr(live, "_storage", None)
        if hasattr(storage, "retries"):
            reg.gauge("checkpoint_storage_retries", unit="retries",
                      help="storage op retries under the RetryingBackend"
                      ).set(storage.retries)
            reg.gauge("checkpoint_storage_gave_up", unit="failures",
                      help="storage ops that exhausted their retry budget"
                      ).set(storage.gave_up)

    registry.register_callback(_cb)
    return _cb


# ------------------------------------------------------- ui event pipeline
def publish_stats_update(record: dict, registry: Optional[MetricsRegistry]
                         = None):
    """Bridge one ``ui.stats.StatsListener`` update record into the
    registry (score/throughput gauges) and the trace/flight pipeline (an
    instant event), so the UI dashboard and the metrics export share one
    source. Never raises — a broken bridge must not break the step."""
    try:
        reg = registry if registry is not None else get_registry()
        score = record.get("score")
        if score is not None:
            reg.gauge("train_score", unit="loss",
                      help="most recent minibatch training score"
                      ).set(float(score))
        reg.gauge("train_iteration", unit="steps",
                  help="most recent training iteration reported"
                  ).set(record.get("iteration", 0))
        perf = record.get("performance") or {}
        if "examples_per_second" in perf:
            reg.gauge("train_examples_per_sec", unit="examples/s",
                      help="training throughput over the last report window"
                      ).set(perf["examples_per_second"])
        from deeplearning4j_tpu_torch.obs.trace import get_tracer
        get_tracer().event("ui.stats_update",
                           iteration=record.get("iteration"),
                           score=score)
    except Exception as e:
        log.debug("publish_stats_update failed (%s: %s)",
                  type(e).__name__, e)
