"""Classification evaluation.

Parity surface: reference deeplearning4j-nn/.../eval/Evaluation.java
(:285 eval(realOutcomes, guesses), :499 stats(), :1031 f1(), :1138 accuracy()),
ConfusionMatrix.java, EvaluationBinary.java.

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``: the same counts
and statistics for the same arrays.
Mask-aware for time-series (reference: time-series eval with label masks).
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch


def as_host(a, dtype=None) -> np.ndarray:
    """``a`` (a numpy array, a list or a tensor on any device) as a numpy
    array, in ``dtype`` when given."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


def _on_card(*arrays) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor among ``arrays``, else None."""
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


class ConfusionMatrix:
    """reference eval/ConfusionMatrix.java. Counts added on the card
    (``add_device``) stay there until ``matrix`` is read: one host read
    for any number of batches."""

    def __init__(self, n_classes: int):
        self._matrix = np.zeros((n_classes, n_classes), np.int64)
        self._pending: Optional[torch.Tensor] = None

    @property
    def matrix(self) -> np.ndarray:
        if self._pending is not None:
            self._matrix += self._pending.cpu().numpy()
            self._pending = None
        return self._matrix

    @matrix.setter
    def matrix(self, value):
        self._matrix = np.asarray(value, np.int64)
        self._pending = None

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def add_device(self, counts: torch.Tensor):
        """Add an (n, n) int64 count tensor on the card, without a read."""
        self._pending = counts if self._pending is None else self._pending + counts

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def to_json(self) -> str:
        return json.dumps({"matrix": self.matrix.tolist()})

    @staticmethod
    def from_json(s: str) -> "ConfusionMatrix":
        m = np.asarray(json.loads(s)["matrix"], np.int64)
        cm = ConfusionMatrix(m.shape[0])
        cm.matrix = m
        return cm


class Evaluation:
    """Accuracy / precision / recall / F1 / confusion matrix (see module
    doc). ``eval`` takes numpy arrays or tensors; with a CUDA tensor the
    counts accumulate on the card (one ``torch.bincount`` over
    ``actual * n + predicted`` a batch, masked rows sent to a spare bin)
    and are read once, by the first statistic asked for."""

    def __init__(self, n_classes: Optional[int] = None, labels: Optional[List[str]] = None,
                 top_n: int = 1):
        self.n_classes = n_classes
        self.label_names = labels
        self.top_n = max(1, int(top_n))
        self._top_n_correct = 0
        self._top_n_total = 0
        self._top_n_pending = None  # (correct, total) int64 tensors on the card
        self.confusion: Optional[ConfusionMatrix] = None

    def _ensure(self, n):
        if self.confusion is None:
            if self.n_classes is not None and self.n_classes != n:
                raise ValueError(
                    f"Batch has {n} classes; evaluation was constructed with "
                    f"n_classes={self.n_classes}")
            self.n_classes = n
            self.confusion = ConfusionMatrix(n)
        elif n != self.n_classes:
            raise ValueError(
                f"Batch has {n} classes; previous batches had {self.n_classes}")

    def eval(self, labels, predictions, mask=None):
        """Accumulate a batch (reference Evaluation.eval :285). ``labels`` is
        one-hot (batch, n) or (batch, time, n); ``predictions`` are
        probabilities of the same shape; ``mask`` (batch,) or (batch, time)."""
        dev = _on_card(labels, predictions, mask)
        if dev is not None:
            return self._eval_device(labels, predictions, mask, dev)
        labels = as_host(labels)
        predictions = as_host(predictions)
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels.reshape(-1, labels.shape[-1]), axis=-1)
        pred = np.argmax(predictions.reshape(-1, predictions.shape[-1]), axis=-1)
        flat_preds = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            actual, pred = actual[m], pred[m]
            flat_preds = flat_preds[m]
        self.confusion.add(actual, pred)
        if self.top_n > 1:
            # top-N accuracy (reference Evaluation.java topNCorrectCount,
            # constructor Evaluation(List<String> labels, int topN))
            k = min(self.top_n, flat_preds.shape[-1])
            topk = np.argpartition(-flat_preds, k - 1, axis=-1)[:, :k]
            self._top_n_correct += int((topk == actual[:, None]).any(axis=-1).sum())
            self._top_n_total += len(actual)

    def _eval_device(self, labels, predictions, mask, dev):
        """``eval`` on the card: no host read. argmax takes the first
        maximal index, as numpy's does."""
        def on(a):
            return torch.as_tensor(a).to(dev, non_blocking=True)
        labels, predictions = on(labels), on(predictions)
        n = int(labels.shape[-1])
        self._ensure(n)
        flat = predictions.reshape(-1, n)
        actual = labels.reshape(-1, n).argmax(-1)
        pred = flat.argmax(-1)
        idx = actual * n + pred
        keep = None
        if mask is not None:
            keep = on(mask).reshape(-1) != 0
            idx = torch.where(keep, idx, torch.full_like(idx, n * n))
        counts = torch.bincount(idx, minlength=n * n + 1)[:n * n].view(n, n)
        self.confusion.add_device(counts)
        if self.top_n > 1:
            k = min(self.top_n, n)
            hit = (flat.topk(k, dim=-1).indices == actual[:, None]).any(-1)
            if keep is not None:
                hit = hit & keep
            total = keep.sum() if keep is not None else torch.ones_like(actual).sum()
            got = (hit.sum(), total)
            p = self._top_n_pending
            self._top_n_pending = got if p is None else (p[0] + got[0], p[1] + got[1])

    def _read_top_n(self):
        if self._top_n_pending is not None:
            correct, total = self._top_n_pending
            self._top_n_pending = None
            self._top_n_correct += int(correct)
            self._top_n_total += int(total)

    # ---- metrics ----
    def _tp(self, i):
        return self.confusion.matrix[i, i]

    def _fp(self, i):
        return self.confusion.matrix[:, i].sum() - self._tp(i)

    def _fn(self, i):
        return self.confusion.matrix[i, :].sum() - self._tp(i)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fp(cls)
            return float(self._tp(cls) / d) if d else 0.0
        vals = [self.precision(i) for i in range(self.n_classes)
                if (self.confusion.matrix[i, :].sum() + self.confusion.matrix[:, i].sum()) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fn(cls)
            return float(self._tp(cls) / d) if d else 0.0
        vals = [self.recall(i) for i in range(self.n_classes)
                if self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        """reference Evaluation.f1 :1031"""
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class is in the top-N predicted
        probabilities (reference Evaluation.topNAccuracy :1187)."""
        if self.top_n == 1:
            return self.accuracy()
        self._read_top_n()
        return (self._top_n_correct / self._top_n_total
                if self._top_n_total else 0.0)

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion.matrix
        tn = m.sum() - m[cls, :].sum() - m[:, cls].sum() + m[cls, cls]
        fp = self._fp(cls)
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def merge(self, other: "Evaluation"):
        """Accumulate another Evaluation (reference Evaluation.merge :1392 —
        the distributed/Spark aggregation contract: per-host evals merge
        into one). A fresh accumulator adopts the other's configuration."""
        if other.confusion is None:  # other never evaluated anything
            return self
        if self.confusion is None:
            if self.top_n == 1:  # unconfigured default adopts other's
                self.top_n = other.top_n
            self._ensure(other.n_classes)
        elif self.n_classes != other.n_classes:
            raise ValueError(
                f"Cannot merge {other.n_classes}-class into "
                f"{self.n_classes}-class Evaluation")
        if self.top_n != other.top_n:
            raise ValueError(
                f"Cannot merge top_n={other.top_n} stats into top_n="
                f"{self.top_n} (top-N counts would be incoherent)")
        if self.label_names is None:  # direction-independent stats() output
            self.label_names = other.label_names
        self.confusion.matrix += other.confusion.matrix
        other._read_top_n()
        self._top_n_correct += other._top_n_correct
        self._top_n_total += other._top_n_total
        return self

    def to_json(self) -> str:
        """The counts and configuration as JSON (``from_json`` reads it)."""
        self._read_top_n()
        return json.dumps({
            "n_classes": self.n_classes, "labels": self.label_names, "top_n": self.top_n,
            "top_n_correct": self._top_n_correct, "top_n_total": self._top_n_total,
            "confusion": None if self.confusion is None else self.confusion.matrix.tolist()})

    @staticmethod
    def from_json(s: str) -> "Evaluation":
        d = json.loads(s)
        e = Evaluation(d["n_classes"], d.get("labels"), d.get("top_n", 1))
        if d.get("confusion") is not None:
            e._ensure(len(d["confusion"]))
            e.confusion.matrix = d["confusion"]
        e._top_n_correct = int(d.get("top_n_correct", 0))
        e._top_n_total = int(d.get("top_n_total", 0))
        return e

    def stats(self) -> str:
        """Human-readable summary (reference Evaluation.stats :499)."""
        names = self.label_names or [str(i) for i in range(self.n_classes)]
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes:    {self.n_classes}",
                 f" Accuracy:        {self.accuracy():.4f}",
                 f" Precision:       {self.precision():.4f}",
                 f" Recall:          {self.recall():.4f}",
                 f" F1 Score:        {self.f1():.4f}",
                 "", "=========================Confusion Matrix=========================="]
        m = self.confusion.matrix
        header = "      " + " ".join(f"{n:>6}" for n in names)
        lines.append(header)
        for i, row in enumerate(m):
            lines.append(f"{names[i]:>6}" + " ".join(f"{v:>6}" for v in row))
        lines.append("===================================================================")
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary metrics for multi-label outputs (reference
    eval/EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = None

    def eval(self, labels, predictions, mask=None):
        labels = as_host(labels).reshape(-1, as_host(labels).shape[-1])
        preds = (as_host(predictions).reshape(labels.shape) >= self.threshold)
        lab = labels >= 0.5
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            lab, preds = lab[m], preds[m]
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        self.tp += (lab & preds).sum(0)
        self.fp += (~lab & preds).sum(0)
        self.tn += (~lab & ~preds).sum(0)
        self.fn += (lab & ~preds).sum(0)

    def merge(self, other: "EvaluationBinary"):
        """reference EvaluationBinary.merge (distributed aggregation)."""
        if other.tp is None:
            return self
        if self.threshold != other.threshold:
            raise ValueError(
                f"Cannot merge threshold={other.threshold} stats into "
                f"threshold={self.threshold} (counts would be incoherent)")
        if self.tp is None:
            self.tp = other.tp.copy()
            self.fp = other.fp.copy()
            self.tn = other.tn.copy()
            self.fn = other.fn.copy()
            return self
        if len(self.tp) != len(other.tp):
            raise ValueError(
                f"Cannot merge {len(other.tp)}-output stats into "
                f"{len(self.tp)}-output EvaluationBinary")
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0
