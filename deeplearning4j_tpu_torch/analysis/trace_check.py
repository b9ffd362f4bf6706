"""Hazard detection: the performance bugs that fail silently (counterpart
of ``deeplearning4j_tpu/analysis/trace_check.py``).

Three kinds of mistake never raise; they make the step loop slow:

1. **Host-device sync points**: an implicit ``float(loss)`` /
   ``bool(x > 0)`` / ``x.item()`` / ``np.asarray(out)`` on a CUDA tensor
   blocks the host until the card drains its queue, and the host stops
   running ahead of the device.
2. **Recompiles**: a watched function dispatched at a new shape or dtype
   after its first (a ragged final batch, a drifting mask layout). With no
   jit the port pays for it in the caching allocator's growth and in
   first-use kernel builds; a drift every step defeats both.
3. **Captured constants**: a large tensor held in a watched function's
   closure, where it should be an argument.

``trace_check()`` wraps a fit or predict region and reports all three::

    with analysis.trace_check(model=net) as report:
        net.fit(data)
    print(report.summary())

Sync points are caught by interposing ``torch.Tensor``'s ``__float__``,
``__bool__``, ``__int__``, ``__index__``, ``item``, ``tolist`` and
``__array__`` for tensors on ``sync_devices`` (the card by default), each
with the caller's file:line. Recompiles and captured constants come from
``perf.compile_watch``'s dispatch observers, which see every watched call
(a network's ``train`` / ``tbptt`` / ``output`` / ``score``) with its
arguments; a function's closure is searched once, at its first dispatch at
each signature. Findings surface through ``TrainingStats`` counters (pass
``stats=``) and ``ParallelInference.stats()["trace_hazards"]`` (the
report attaches to ``model`` as ``last_trace_report``). The monitor
patches process-global entry points: it is a diagnostic for one region at
a time, not an always-on profiler (nesting raises).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceHazard", "TraceReport", "trace_check"]


@dataclasses.dataclass
class TraceHazard:
    """kind: 'sync' | 'recompile' | 'captured-const'."""

    kind: str
    where: str     # caller file:line for syncs; the watched key for the others
    detail: str
    count: int = 1

    def __str__(self):
        times = f" (x{self.count})" if self.count > 1 else ""
        return f"[{self.kind}] {self.where}{times}: {self.detail}"


class TraceReport:
    def __init__(self):
        self.hazards: List[TraceHazard] = []

    def _by_kind(self, kind: str) -> List[TraceHazard]:
        return [h for h in self.hazards if h.kind == kind]

    @property
    def sync_points(self) -> List[TraceHazard]:
        return self._by_kind("sync")

    @property
    def recompiles(self) -> List[TraceHazard]:
        return self._by_kind("recompile")

    @property
    def captured_constants(self) -> List[TraceHazard]:
        return self._by_kind("captured-const")

    def counts(self) -> Dict[str, int]:
        """Aggregate counters, TrainingStats/stats()-shaped."""
        return {
            "trace_sync_points": sum(h.count for h in self.sync_points),
            "trace_recompiles": sum(h.count for h in self.recompiles),
            "trace_captured_consts": len(self.captured_constants),
        }

    def to_stats(self, stats) -> None:
        """Record the aggregate counters into a parallel.TrainingStats."""
        for k, v in self.counts().items():
            stats.set_counter(k, v)

    def summary(self) -> str:
        if not self.hazards:
            return "trace_check: no hazards detected"
        lines = [f"trace_check: {len(self.hazards)} finding(s)"]
        lines.extend(f"  {h}" for h in self.hazards)
        return "\n".join(lines)


def _caller() -> str:
    """file:line of the frame that made a sync, skipping this module and
    torch's and numpy's own frames."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn == __file__ or "/torch/" in fn or "/numpy/" in fn):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _closure_tensors(fn) -> list:
    """Tensors in ``fn``'s closure cells (the function under a bound method
    or a ``functools.partial`` too, and a partial's bound arguments)."""
    import functools

    import torch
    out = []
    seen = set()
    while fn is not None and id(fn) not in seen:
        seen.add(id(fn))
        if isinstance(fn, functools.partial):
            out.extend(v for v in list(fn.args) + list(fn.keywords.values())
                       if isinstance(v, torch.Tensor))
            fn = fn.func
            continue
        fn = getattr(fn, "__func__", fn)
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:  # an empty cell
                continue
            if isinstance(v, torch.Tensor):
                out.append(v)
        fn = getattr(fn, "__wrapped__", None)
    return out


_active_lock = threading.Lock()
_active: Optional["trace_check"] = None
_SYNC_METHODS = ("__float__", "__bool__", "__int__", "__index__", "item", "tolist",
                 "__array__")


class trace_check:
    """Context manager; see the module docstring.

    - ``model``: attach the report as ``model.last_trace_report`` so
      ``ParallelInference.stats()`` surfaces the hazard counts.
    - ``stats``: a ``parallel.TrainingStats`` to receive the counters.
    - ``check_constants``: search each watched function's closure at its
      first dispatch of each signature.
    - ``const_min_bytes``: smaller tensors are scalars or configuration,
      not hazards.
    - ``sync_devices``: device types whose conversions count as syncs
      (the card; a CPU tensor's conversion waits for nothing).
    """

    def __init__(self, model=None, stats=None, check_constants: bool = True,
                 const_min_bytes: int = 4096, sync_devices: Tuple[str, ...] = ("cuda",)):
        self._model = model
        self._stats = stats
        self._check_constants = check_constants
        self._const_min_bytes = const_min_bytes
        self._sync_devices = tuple(sync_devices)
        self.report = TraceReport()
        self._sync_events: Dict[Tuple[str, str], int] = {}
        self._compile_counts: Dict[str, int] = {}
        self._events_lock = threading.Lock()
        self._restores: list = []

    # ------------------------------------------------------------- recording
    def _record_sync(self, op: str):
        where = _caller()
        with self._events_lock:
            key = (where, op)
            self._sync_events[key] = self._sync_events.get(key, 0) + 1

    def _on_dispatch(self, key, fn, args, kwargs, compiled):
        if not compiled:
            return
        with self._events_lock:
            self._compile_counts[key] = self._compile_counts.get(key, 0) + compiled
        if self._check_constants:
            self._find_captured_consts(key, fn)

    def _find_captured_consts(self, key, fn):
        for t in _closure_tensors(fn):
            nbytes = t.numel() * t.element_size()
            if nbytes >= self._const_min_bytes:
                self.report.hazards.append(TraceHazard(
                    "captured-const", key,
                    f"tensor shape={tuple(t.shape)} dtype={t.dtype} ({int(nbytes)} B) is "
                    "held in the watched function's closure; pass it as an argument "
                    "so a new value is a new input, not a hidden constant"))

    # ------------------------------------------------------------- patching
    def _install(self):
        import torch

        from deeplearning4j_tpu_torch.perf import compile_watch
        devices = self._sync_devices
        record = self._record_sync

        def wrapper(op, orig):
            def w(t, *a, **k):
                if t.device.type in devices:
                    record(op)
                return orig(t, *a, **k)
            return w

        for name in _SYNC_METHODS:
            orig = getattr(torch.Tensor, name)
            setattr(torch.Tensor, name, wrapper(f"Tensor.{name}", orig))
            self._restores.append((name, orig))
        compile_watch.add_dispatch_observer(self._on_dispatch)

    def _uninstall(self):
        import torch

        from deeplearning4j_tpu_torch.perf import compile_watch
        compile_watch.remove_dispatch_observer(self._on_dispatch)
        for name, orig in reversed(self._restores):
            setattr(torch.Tensor, name, orig)
        self._restores = []

    # ------------------------------------------------------------- protocol
    def __enter__(self) -> TraceReport:
        global _active
        with _active_lock:
            if _active is not None:
                raise RuntimeError("trace_check regions cannot nest (the monitor patches "
                                   "process-global entry points)")
            _active = self
        self._install()
        return self.report

    def __exit__(self, exc_type, exc, tb):
        global _active
        self._uninstall()
        with _active_lock:
            _active = None
        with self._events_lock:
            for (where, op), count in sorted(self._sync_events.items()):
                self.report.hazards.append(TraceHazard(
                    "sync", where,
                    f"implicit host-device sync via {op} on a device tensor — blocks the "
                    "host until the device drains; hoist it out of the step loop or "
                    "batch the reads", count=count))
            for key, compiles in sorted(self._compile_counts.items()):
                if compiles >= 2:
                    self.report.hazards.append(TraceHazard(
                        "recompile", key,
                        f"dispatched at {compiles} shapes inside one region — shapes or "
                        "dtypes shift between calls; pad to a bucket ladder "
                        "(perf.BucketPolicy) or fix the dtype drift", count=compiles))
        if self._stats is not None:
            self.report.to_stats(self._stats)
        if self._model is not None:
            self._model.last_trace_report = self.report
        return False
