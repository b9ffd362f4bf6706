"""Phase timing of data-parallel training (counterpart of
``deeplearning4j_tpu/parallel/stats.py``; reference
``CommonSparkTrainingStats``: per-phase timings and the key set).

Phases are host wall-clock spans: ``data_placement`` (this rank's rows
onto its device), ``train_dispatch`` (the step: PyTorch launches its work
asynchronously on a card, so this is mostly host time) and ``epoch_sync``
(one ``torch.cuda.synchronize`` an epoch, where the card's queued work
shows up). ``counters`` carry point-in-time gauges beside the timings.
``obs.watch_training_stats`` reads a live instance at scrape time.
"""

from __future__ import annotations

import time
from typing import Dict, List


class TrainingStats:
    """Accumulates (phase -> durations); mirrors the reference's
    getValue(key)/getKeySet surface with host wall-clock measurements."""

    def __init__(self):
        self._durations: Dict[str, List[float]] = {}
        self.examples = 0
        self.minibatches = 0
        self.counters: Dict[str, int] = {}  # lint: disable=DLT007 (pre-obs surface; absorbed into the registry by obs.absorb_training_stats)

    # -------------------------------------------------------------- record
    class _Timer:
        def __init__(self, stats: "TrainingStats", phase: str):
            self.stats = stats
            self.phase = phase

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.stats.record(self.phase, time.perf_counter() - self.t0)

    def time(self, phase: str) -> "_Timer":
        return self._Timer(self, phase)

    def record(self, phase: str, seconds: float):
        self._durations.setdefault(phase, []).append(seconds)

    def set_counter(self, name: str, value: int):
        """Set a point-in-time gauge (e.g. cumulative compile count)."""
        self.counters[name] = int(value)

    def inc_counter(self, name: str, by: int = 1):
        self.counters[name] = self.counters.get(name, 0) + int(by)

    # --------------------------------------------------------------- query
    def key_set(self):
        return sorted(self._durations)

    def get_value(self, phase: str) -> List[float]:
        return list(self._durations.get(phase, []))

    def total_seconds(self, phase: str) -> float:
        return sum(self._durations.get(phase, []))

    def count(self, phase: str) -> int:
        return len(self._durations.get(phase, []))

    def as_dict(self) -> dict:
        out = {"examples": self.examples, "minibatches": self.minibatches}
        if self.counters:
            out["counters"] = dict(self.counters)
        for phase, ds in self._durations.items():
            out[phase] = {"count": len(ds), "total_ms": sum(ds) * 1000.0,
                          "mean_ms": sum(ds) / len(ds) * 1000.0}
        return out

    def to_string(self) -> str:
        lines = [f"TrainingStats: {self.examples} examples, "
                 f"{self.minibatches} minibatches"]
        for phase in self.key_set():
            ds = self._durations[phase]
            lines.append(f"  {phase:<16} n={len(ds):<6} "
                         f"total={sum(ds) * 1000:9.1f} ms  "
                         f"mean={sum(ds) / len(ds) * 1000:7.2f} ms")
        for name in sorted(self.counters):
            lines.append(f"  {name:<16} {self.counters[name]}")
        return "\n".join(lines)
