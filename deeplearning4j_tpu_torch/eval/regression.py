"""Regression metrics.

Parity surface: reference eval/RegressionEvaluation.java — per-column MSE,
MAE, RMSE, RSE (relative squared error), PC (Pearson correlation), R^2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import as_host


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.sum_err2 = None
        self.sum_abs = None
        self.sum_label = None
        self.sum_label2 = None
        self.sum_pred = None
        self.sum_pred2 = None
        self.sum_lp = None
        if n_columns is not None:
            self._alloc(n_columns)

    def _alloc(self, c: int):
        self.sum_err2 = np.zeros(c)
        self.sum_abs = np.zeros(c)
        self.sum_label = np.zeros(c)
        self.sum_label2 = np.zeros(c)
        self.sum_pred = np.zeros(c)
        self.sum_pred2 = np.zeros(c)
        self.sum_lp = np.zeros(c)

    def eval(self, labels, predictions, mask=None):
        labels = as_host(labels, np.float64)
        preds = as_host(predictions, np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        if self.sum_err2 is None:
            self._alloc(labels.shape[-1])
        elif labels.shape[-1] != len(self.sum_err2):
            raise ValueError(
                f"Batch has {labels.shape[-1]} columns; evaluation was "
                f"initialized with {len(self.sum_err2)}")
        e = preds - labels
        self.n += labels.shape[0]
        self.sum_err2 += (e * e).sum(0)
        self.sum_abs += np.abs(e).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label2 += (labels * labels).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred2 += (preds * preds).sum(0)
        self.sum_lp += (labels * preds).sum(0)

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        mean_label = self.sum_label[col] / self.n
        denom = self.sum_label2[col] - 2 * mean_label * self.sum_label[col] \
            + self.n * mean_label ** 2
        return float(self.sum_err2[col] / denom) if denom else 0.0

    def pearson_correlation(self, col: int) -> float:
        n = self.n
        num = n * self.sum_lp[col] - self.sum_label[col] * self.sum_pred[col]
        d1 = n * self.sum_label2[col] - self.sum_label[col] ** 2
        d2 = n * self.sum_pred2[col] - self.sum_pred[col] ** 2
        d = np.sqrt(d1 * d2)
        return float(num / d) if d else 0.0

    def r_squared(self, col: int) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err2 / self.n))

    def merge(self, other: "RegressionEvaluation"):
        """reference RegressionEvaluation.merge (distributed aggregation):
        all accumulators are sums, so merging is elementwise addition."""
        if other.sum_err2 is None:
            return self
        if self.sum_err2 is None:
            self._alloc(len(other.sum_err2))
        elif len(self.sum_err2) != len(other.sum_err2):
            raise ValueError("Column-count mismatch in merge")
        self.n += other.n
        for name in ("sum_err2", "sum_abs", "sum_label", "sum_label2",
                     "sum_pred", "sum_pred2", "sum_lp"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        return self

    def stats(self) -> str:
        c = len(self.sum_err2)
        lines = ["Column    MSE            MAE            RMSE           RSE            PC             R^2"]
        for i in range(c):
            lines.append(
                f"col_{i:<5} {self.mean_squared_error(i):<14.6g} "
                f"{self.mean_absolute_error(i):<14.6g} "
                f"{self.root_mean_squared_error(i):<14.6g} "
                f"{self.relative_squared_error(i):<14.6g} "
                f"{self.pearson_correlation(i):<14.6g} "
                f"{self.r_squared(i):<14.6g}")
        return "\n".join(lines)
