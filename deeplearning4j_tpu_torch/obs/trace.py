"""Low-overhead host-side span tracer + the synced bench Stopwatch
(counterpart of ``deeplearning4j_tpu/obs/trace.py``).

Spans answer the question metrics can't: *why was step 812 slow* — was the
host waiting on data, dispatching, or blocked on the device? The tracer is
explicit-clock (injectable ``clock``; an overhead test counts clock calls
instead of trusting wall time) and DISABLED by default with a near-zero-cost
no-op path: ``span()`` on a disabled tracer returns a shared singleton — no
allocation, no clock read, no sink dispatch.

Finished spans and instant events are dispatched to *sinks* (the crash
flight recorder's ring, a JSONL event log) and — when the tracer carries a
registry — observed into an auto-registered ``<span>_ms`` histogram.

``Stopwatch.stop(sync=x)`` waits for the card before it reads the clock:
where the JAX package blocks on ``x``'s buffers, the port synchronizes
every CUDA device that holds a tensor of ``x`` (a tensor, or lists, tuples
and dicts of them), since kernels are enqueued asynchronously.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

log = logging.getLogger(__name__)

__all__ = ["Tracer", "get_tracer", "configure_tracer", "Stopwatch"]


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer's entire cost is
    returning this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "_t0", "_wall", "_done")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self._wall = time.time()
        self._t0 = tracer.clock()
        self._done = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self):
        if self._done:
            return
        self._done = True
        dur_ms = (self.tracer.clock() - self._t0) * 1000.0
        self.tracer._dispatch({"kind": "span", "name": self.name,
                               "wall": self._wall,
                               "dur_ms": round(dur_ms, 4),
                               "attrs": self.attrs})


class Tracer:
    """See module docstring.

    ``clock`` is the duration clock (default ``time.perf_counter``);
    wall-clock timestamps for the event log come from ``time.time``.
    ``registry`` (a ``obs.registry.MetricsRegistry``) makes every span
    also an observation in a ``<name>_ms`` histogram (dots become
    underscores)."""

    def __init__(self, enabled: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 registry=None):
        self.enabled = bool(enabled)
        self.clock = clock
        self.registry = registry
        self._sinks: List[Callable[[dict], None]] = []
        self._sink_lock = threading.Lock()

    # ---------------------------------------------------------------- sinks
    def add_sink(self, sink: Callable[[dict], None]):
        with self._sink_lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
        return sink

    def remove_sink(self, sink):
        with self._sink_lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def _dispatch(self, record: dict):
        if self.registry is not None and record["kind"] == "span":
            try:
                name = record["name"].replace(".", "_")
                self.registry.histogram(
                    f"{name}_ms", unit="ms",
                    help=f"duration of span '{record['name']}' "
                         "(auto-registered by the tracer)"
                ).observe(record["dur_ms"])
            except Exception as e:
                log.debug("span histogram observe failed (%s: %s)",
                          type(e).__name__, e)
        with self._sink_lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(record)
            except Exception as e:  # observability never breaks the step
                log.debug("trace sink failed (%s: %s)", type(e).__name__, e)

    # ----------------------------------------------------------------- API
    def span(self, name: str, **attrs):
        """Context manager timing a host-side section. Disabled tracer:
        returns the shared no-op singleton (no clock read, no alloc)."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs):
        """Instant event (no duration) into the same sinks."""
        if not self.enabled:
            return
        self._dispatch({"kind": "event", "name": name, "wall": time.time(),
                        "dur_ms": 0.0, "attrs": attrs})

    def wrap_iter(self, iterable, name: str):
        """Time each ``next()`` of ``iterable`` as a span — how the fit
        loops measure data-wait without restructuring. Disabled tracer:
        the iterable is returned UNCHANGED (zero per-batch cost)."""
        if not self.enabled:
            return iterable

        def gen():
            it = iter(iterable)
            i = 0
            while True:
                sp = self.span(name, index=i)
                try:
                    item = next(it)
                except StopIteration:
                    return  # the exhausted probe is not a data wait:
                    # its span is dropped, so N items → N spans
                sp.end()
                yield item
                i += 1
        return gen()


# ---------------------------------------------------------- global default
_global_lock = threading.Lock()
_global: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process-wide tracer (disabled until configured)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Tracer(enabled=False)
        return _global


def configure_tracer(enabled: Optional[bool] = None, clock=None,
                     registry=None) -> Tracer:
    """Reconfigure the global tracer in place (handles held by
    instrumented code stay valid). Passing ``registry`` also turns span →
    histogram observation on; ``configure_tracer(enabled=True,
    registry=get_registry())`` is the standard \"turn telemetry on\"
    call."""
    t = get_tracer()
    if enabled is not None:
        t.enabled = bool(enabled)
    if clock is not None:
        t.clock = clock
    if registry is not None:
        t.registry = registry
    return t


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in ``tree``."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif getattr(tree, "is_cuda", False):
        out.add(tree.device)
    return out


class Stopwatch:
    """Synced stopwatch for benches and tools. ``stop(sync=x)`` waits for
    every CUDA device holding a tensor of ``x`` (``torch.cuda.synchronize``)
    BEFORE reading the clock, so an asynchronously enqueued result cannot
    fake a fast measurement; call ``stop()`` bare only when the measured
    call already synced (a host-side join, a function that fetches values
    itself).

    Usage::

        sw = Stopwatch().start()
        out = step(x)
        dt = sw.stop(out)          # blocks on `out`, then stops the clock

    or as a context manager (no sync — for already-synced bodies)::

        with Stopwatch() as sw:
            run_and_fetch()
        print(sw.seconds)
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0: Optional[float] = None
        self.seconds: float = 0.0

    def start(self) -> "Stopwatch":
        self._t0 = self._clock()
        return self

    def stop(self, sync=None) -> float:
        """Optionally wait for ``sync`` (tensors, at any depth of lists,
        tuples and dicts), then stop. Returns (and stores in ``seconds``)
        the elapsed time."""
        if sync is not None:
            devices = _cuda_devices(sync, set())
            if devices:
                import torch
                for dev in devices:
                    torch.cuda.synchronize(dev)
        if self._t0 is None:
            raise RuntimeError("Stopwatch.stop() before start()")
        self.seconds = self._clock() - self._t0
        return self.seconds

    def __enter__(self) -> "Stopwatch":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
