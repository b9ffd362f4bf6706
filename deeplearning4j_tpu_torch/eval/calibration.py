"""Probability-calibration evaluation.

Parity surface: reference deeplearning4j-nn/.../eval/EvaluationCalibration.java
(:56 reliabilityDiagBins/histogramBins, :106 eval accumulation,
:200 getReliabilityDiagram, :241 getResidualPlot, :263 getProbabilityHistogram).

Accumulates fixed-size binned counts per class, so memory is O(classes x bins)
regardless of eval-set size; host-side bookkeeping over the returned
probabilities (tensors are read to the host), the JAX package's counts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.curves import Histogram, ReliabilityDiagram
from deeplearning4j_tpu_torch.eval.evaluation import as_host


class EvaluationCalibration:
    """Reliability diagrams, residual plots and probability histograms."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = int(reliability_bins)
        self.histogram_bins = int(histogram_bins)
        self.n_classes: Optional[int] = None
        # per (class, reliability bin): positives, totals, sum of predictions
        self._r_pos = None
        self._r_tot = None
        self._r_sum = None
        # per (class, histogram bin): residual |label - p| and probability counts
        self._resid = None
        self._prob_all = None
        self._prob_pos = None

    def _ensure(self, n: int):
        if self.n_classes is None:
            self.n_classes = n
            rb, hb = self.reliability_bins, self.histogram_bins
            self._r_pos = np.zeros((n, rb), np.int64)
            self._r_tot = np.zeros((n, rb), np.int64)
            self._r_sum = np.zeros((n, rb), np.float64)
            self._resid = np.zeros((n, hb), np.int64)
            self._prob_all = np.zeros((n, hb), np.int64)
            self._prob_pos = np.zeros((n, hb), np.int64)
        elif n != self.n_classes:
            raise ValueError(
                f"Batch has {n} classes; previous batches had {self.n_classes}")

    def eval(self, labels, predictions, mask=None):
        labels = as_host(labels, np.float64)
        preds = as_host(predictions, np.float64)
        n = labels.shape[-1]
        self._ensure(n)
        lab2 = labels.reshape(-1, n)
        pr2 = preds.reshape(-1, n)
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            lab2, pr2 = lab2[m], pr2[m]
        rb, hb = self.reliability_bins, self.histogram_bins
        rbin = np.clip((pr2 * rb).astype(np.int64), 0, rb - 1)
        hbin = np.clip((pr2 * hb).astype(np.int64), 0, hb - 1)
        resbin = np.clip((np.abs(lab2 - pr2) * hb).astype(np.int64), 0, hb - 1)
        pos = lab2 > 0.5
        for c in range(n):
            np.add.at(self._r_tot[c], rbin[:, c], 1)
            np.add.at(self._r_pos[c], rbin[:, c][pos[:, c]], 1)
            np.add.at(self._r_sum[c], rbin[:, c], pr2[:, c])
            np.add.at(self._resid[c], resbin[:, c], 1)
            np.add.at(self._prob_all[c], hbin[:, c], 1)
            np.add.at(self._prob_pos[c], hbin[:, c][pos[:, c]], 1)

    def get_reliability_diagram(self, cls: int) -> ReliabilityDiagram:
        """reference EvaluationCalibration.getReliabilityDiagram :200 —
        empty bins are dropped."""
        tot = self._r_tot[cls]
        keep = tot > 0
        mean_pred = self._r_sum[cls][keep] / tot[keep]
        frac_pos = self._r_pos[cls][keep] / tot[keep]
        return ReliabilityDiagram(
            title=f"Reliability diagram (class {cls})",
            mean_predicted_value=[float(v) for v in mean_pred],
            fraction_positives=[float(v) for v in frac_pos])

    def expected_calibration_error(self, cls: int) -> float:
        """Weighted |confidence - accuracy| over reliability bins (standard
        ECE; the reference exposes the diagram, the scalar is a convenience)."""
        tot = self._r_tot[cls]
        total = tot.sum()
        if total == 0:
            return 0.0
        keep = tot > 0
        mean_pred = self._r_sum[cls][keep] / tot[keep]
        frac_pos = self._r_pos[cls][keep] / tot[keep]
        return float(np.sum(tot[keep] / total * np.abs(mean_pred - frac_pos)))

    def get_residual_plot(self, cls: int) -> Histogram:
        """Histogram of |label - p| (reference getResidualPlot :241)."""
        return Histogram(title=f"Residual plot (class {cls})", lower=0.0,
                         upper=1.0, bin_counts=[int(v) for v in self._resid[cls]])

    def get_probability_histogram(self, cls: int, positive_only: bool = False) -> Histogram:
        """Histogram of predicted p (reference getProbabilityHistogram :263)."""
        src = self._prob_pos if positive_only else self._prob_all
        which = "positive-label " if positive_only else ""
        return Histogram(title=f"Predicted {which}probability (class {cls})",
                         lower=0.0, upper=1.0,
                         bin_counts=[int(v) for v in src[cls]])
