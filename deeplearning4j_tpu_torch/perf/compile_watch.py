"""Dispatch and compile counters (counterpart of
``deeplearning4j_tpu/perf/compile_watch.py``).

``CompileWatch.wrap(fn, key)`` wraps a callable so every call records one
*dispatch*, and a *compile* the first time the call is made at a new
signature (the shape and dtype of every tensor argument, the value of
every bool, int or str argument, the type of every other). The port has
no jit: a "compile" here is what the JAX package's shape-signature
fallback counts, the first dispatch of a function at a shape it has not
run before, which on the card is where the caching allocator grows and
where a kernel may be built and loaded. Tests and
``chip_smoke.py`` then hold "N batches, 1 compile" as the JAX package's
tests do. ``backend_compile_events()`` counts this process's kernel builds
(``perf/kernels/_build.py``: one ``nvcc`` run a library).

Counts aggregate per (watch, key) and into the process-wide ``GLOBAL``
watch. ``bump_active(counter)`` records a freeform event against the
watches of the wrapped call running on this thread (and ``GLOBAL``): the
fused conv→BN blocks count ``fusion.fused_block`` and the kernel wrappers
``kernel.cuda_<family>`` / ``kernel.plain_<family>`` through it
(``perf/kernels/__init__.py``). Dispatch observers (``analysis/
trace_check.py``) see every watched call with its arguments.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["CompileWatch", "GLOBAL", "bump_active", "add_dispatch_observer",
           "remove_dispatch_observer", "backend_compile_events"]


class CompileWatch:
    """Per-key compile/dispatch counters plus freeform integer
    ``counters``. Thread-safe (the inference worker dispatches from its own
    thread)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._compiles: Dict[str, int] = {}
        self._dispatches: Dict[str, int] = {}
        self._counters: Dict[str, int] = {}  # lint: disable=DLT007 (pre-obs surface; absorbed into the registry by obs.absorb_compile_watch)

    # ------------------------------------------------------------ recording
    def _record(self, key: str, compiles: int, dispatches: int):
        with self._lock:
            self._compiles[key] = self._compiles.get(key, 0) + compiles
            self._dispatches[key] = self._dispatches.get(key, 0) + dispatches

    def bump(self, counter: str, by: int = 1):
        """Increment a freeform event counter."""
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + int(by)

    def counter(self, counter: str) -> int:
        with self._lock:
            return self._counters.get(counter, 0)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        with self._lock:
            return {k: v for k, v in self._counters.items() if k.startswith(prefix)}

    def wrap(self, fn, key: str) -> "_WatchedFunction":
        """Wrap a callable; every call records into this watch AND the
        process-wide GLOBAL watch."""
        return _WatchedFunction(fn, key, sinks=(self, GLOBAL))

    # -------------------------------------------------------------- queries
    def compiles(self, key: Optional[str] = None) -> int:
        with self._lock:
            if key is None:
                return sum(self._compiles.values())
            return self._compiles.get(key, 0)

    def dispatches(self, key: Optional[str] = None) -> int:
        with self._lock:
            if key is None:
                return sum(self._dispatches.values())
            return self._dispatches.get(key, 0)

    def reset(self):
        with self._lock:
            self._compiles.clear()
            self._dispatches.clear()
            self._counters.clear()

    def as_dict(self) -> dict:
        with self._lock:
            out = {
                "compiles": sum(self._compiles.values()),
                "dispatches": sum(self._dispatches.values()),
                "by_key": {k: {"compiles": self._compiles.get(k, 0),
                               "dispatches": self._dispatches.get(k, 0)}
                           for k in sorted(set(self._compiles) | set(self._dispatches))},
            }
            if self._counters:
                out["counters"] = dict(self._counters)
            return out


GLOBAL = CompileWatch("global")

# the watches of the wrapped call running on THIS thread: bump_active lands
# an event on the owning model's watch, and always on GLOBAL
_active = threading.local()


def bump_active(counter: str, by: int = 1) -> None:
    sinks = getattr(_active, "sinks", None) or (GLOBAL,)
    for sink in sinks:
        sink.bump(counter, by)
    if GLOBAL not in sinks:
        GLOBAL.bump(counter, by)


# callables invoked after every watched call with (key, fn, args, kwargs,
# compiles); their errors are swallowed: observing never breaks the step
_observers: list = []


def add_dispatch_observer(cb) -> None:
    _observers.append(cb)


def remove_dispatch_observer(cb) -> None:
    try:
        _observers.remove(cb)
    except ValueError:
        pass


def _signature(args, kwargs) -> tuple:
    """(shape, dtype, device type) of every tensor, the value of every
    bool, int, str or None, and the type name of every other leaf of
    ``(args, kwargs)``, lists, tuples and dicts walked."""
    parts = []

    def walk(v):
        if isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(v[k])
        else:
            shape = getattr(v, "shape", None)
            if shape is not None:
                dev = getattr(v, "device", None)
                parts.append((tuple(shape), str(getattr(v, "dtype", "")),
                              getattr(dev, "type", "")))
            elif isinstance(v, (bool, int, str)) or v is None:
                parts.append((type(v).__name__, v))  # shape-deciding scalars (k, ...)
            else:
                parts.append((type(v).__name__,))

    walk((args, kwargs))
    return tuple(parts)


class _WatchedFunction:
    """Callable proxy that counts dispatches and first-seen signatures."""

    def __init__(self, fn, key: str, sinks):
        self._fn = fn
        self._key = key
        self._sinks = sinks
        self._seen_sigs = set()
        self._sig_lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        prev = getattr(_active, "sinks", None)
        _active.sinks = self._sinks
        try:
            out = self._fn(*args, **kwargs)
        finally:
            _active.sinks = prev
        sig = _signature(args, kwargs)
        with self._sig_lock:
            compiled = 0 if sig in self._seen_sigs else 1
            self._seen_sigs.add(sig)
        for sink in self._sinks:
            sink._record(self._key, compiled, 1)
        for cb in list(_observers):
            try:
                cb(self._key, self._fn, args, kwargs, compiled)
            except Exception:
                pass
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


def backend_compile_events() -> int:
    """Kernel libraries this process built (``perf/kernels/_build.py``)."""
    from deeplearning4j_tpu_torch.perf.kernels import _build
    return _build.builds
