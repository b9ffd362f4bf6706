"""Exportable evaluation curves.

Parity surface: reference deeplearning4j-nn/.../eval/curves/
(RocCurve.java, PrecisionRecallCurve.java, Histogram.java,
ReliabilityDiagram.java, BaseCurve.java:toJson/fromJson).

Curves are plain frozen dataclasses with JSON round-trip so they can be
persisted next to StatsStorage files and rendered by the UI module.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np

_CURVE_REGISTRY = {}


def _register(cls):
    _CURVE_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class BaseCurve:
    """JSON serde shared by all curves (reference BaseCurve.java)."""

    def to_json(self) -> str:
        d = {k: (list(v) if isinstance(v, (list, tuple, np.ndarray)) else v)
             for k, v in dataclasses.asdict(self).items()}
        d["@class"] = type(self).__name__
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "BaseCurve":
        d = json.loads(s)
        cls = _CURVE_REGISTRY[d.pop("@class")]
        return cls(**d)


@_register
@dataclasses.dataclass(frozen=True)
class RocCurve(BaseCurve):
    """reference eval/curves/RocCurve.java:28"""

    thresholds: List[float]
    fpr: List[float]
    tpr: List[float]

    def calculate_auc(self) -> float:
        """Trapezoidal area under (fpr, tpr), reference RocCurve.calculateAUC."""
        f = np.asarray(self.fpr)
        t = np.asarray(self.tpr)
        order = np.argsort(f, kind="mergesort")
        return float(np.trapezoid(t[order], f[order]))


@_register
@dataclasses.dataclass(frozen=True)
class PrecisionRecallCurve(BaseCurve):
    """reference eval/curves/PrecisionRecallCurve.java:33"""

    thresholds: List[float]
    precision: List[float]
    recall: List[float]

    def calculate_auprc(self) -> float:
        r = np.asarray(self.recall)
        p = np.asarray(self.precision)
        # collapse duplicate recall values to their best precision before
        # integrating: trapezoid over raw points is sensitive to which tie
        # representative lands next to the adjacent recall level, and the PR
        # staircase semantics (reference PrecisionRecallCurve) take the
        # highest-precision operating point at each recall
        uniq, inv = np.unique(r, return_inverse=True)
        best = np.zeros(len(uniq))
        np.maximum.at(best, inv, p)
        return float(np.trapezoid(best, uniq))


@_register
@dataclasses.dataclass(frozen=True)
class Histogram(BaseCurve):
    """reference eval/curves/Histogram.java: equal-width bins over
    [lower, upper] with integer counts."""

    title: str
    lower: float
    upper: float
    bin_counts: List[int]

    def bin_edges(self) -> np.ndarray:
        return np.linspace(self.lower, self.upper, len(self.bin_counts) + 1)


@_register
@dataclasses.dataclass(frozen=True)
class ReliabilityDiagram(BaseCurve):
    """reference eval/curves/ReliabilityDiagram.java: mean predicted
    probability vs observed positive fraction per bin."""

    title: str
    mean_predicted_value: List[float]
    fraction_positives: List[float]
