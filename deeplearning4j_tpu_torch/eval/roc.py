"""ROC / AUC.

Parity surface: reference eval/ROC.java (706 LoC; exact mode with
thresholdSteps=0 and thresholded mode), ROCBinary.java, ROCMultiClass.java.

Counterpart of ``deeplearning4j_tpu/eval/roc.py`` (the same statistics
for the same arrays); ``eval`` takes numpy arrays or tensors, which it
reads to the host. This implementation accumulates raw (score, label) pairs (the reference's
"exact" mode, the default since 0.9.x) and computes AUROC by rank statistics
and AUPRC by trapezoidal integration of the PR curve.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import as_host


class ROC:
    """Binary ROC: positive class probability vs binary label.

    ``threshold_steps=0`` (default) is the reference's exact mode: raw
    (score, label) pairs are retained and AUROC is computed by rank
    statistics. ``threshold_steps=N`` is the thresholded mode
    (ROC.java:163 pre-0.9.x default): scores are histogrammed into N
    equal-width bins so memory stays O(N) regardless of eval-set size —
    use it for very large evaluations.
    """

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        if self.threshold_steps > 0:
            self._pos_hist = np.zeros(self.threshold_steps, np.int64)
            self._neg_hist = np.zeros(self.threshold_steps, np.int64)

    def eval(self, labels, predictions, mask=None):
        """labels: (n,) {0,1} or one-hot (n,2) (positive = column 1);
        predictions: same shape of probabilities."""
        labels = as_host(labels)
        preds = as_host(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            preds = preds[..., 1]
        labels = labels.reshape(-1)
        preds = preds.reshape(-1)
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        if self.threshold_steps > 0:
            idx = np.clip((preds * self.threshold_steps).astype(np.int64),
                          0, self.threshold_steps - 1)
            pos = labels > 0.5
            np.add.at(self._pos_hist, idx[pos], 1)
            np.add.at(self._neg_hist, idx[~pos], 1)
            return
        self._labels.append(labels.astype(np.float64))
        self._scores.append(preds.astype(np.float64))

    def _collect(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.concatenate(self._scores), np.concatenate(self._labels)

    def _thresholded_rates(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(thresholds, fpr, tpr) from the histograms. ``>= threshold``
        counts are suffix sums of the bin histograms."""
        pos_ge = np.concatenate([np.cumsum(self._pos_hist[::-1])[::-1], [0]])
        neg_ge = np.concatenate([np.cumsum(self._neg_hist[::-1])[::-1], [0]])
        thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        tpr = pos_ge / max(self._pos_hist.sum(), 1)
        fpr = neg_ge / max(self._neg_hist.sum(), 1)
        return thresholds, fpr, tpr

    def calculate_auc(self) -> float:
        """AUROC via the Mann-Whitney U statistic (rank sum), equivalent to
        the reference's exact-mode trapezoidal AUC. In thresholded mode,
        trapezoidal area under the binned curve."""
        if self.threshold_steps > 0:
            _, fpr, tpr = self._thresholded_rates()
            order = np.argsort(fpr, kind="mergesort")
            return float(np.trapezoid(tpr[order], fpr[order]))
        s, y = self._collect()
        pos = s[y > 0.5]
        neg = s[y <= 0.5]
        if len(pos) == 0 or len(neg) == 0:
            return float("nan")
        order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
        ranks = np.empty(len(order))
        ranks[order] = np.arange(1, len(order) + 1)
        # average ranks for ties
        allv = np.concatenate([pos, neg])
        sorted_v = allv[order]
        i = 0
        while i < len(sorted_v):
            j = i
            while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
                j += 1
            if j > i:
                avg = (i + 1 + j + 1) / 2.0
                ranks[order[i:j + 1]] = avg
            i = j + 1
        r_pos = ranks[:len(pos)].sum()
        u = r_pos - len(pos) * (len(pos) + 1) / 2.0
        return float(u / (len(pos) * len(neg)))

    def calculate_auprc(self) -> float:
        if self.threshold_steps > 0:
            pos_ge = np.cumsum(self._pos_hist[::-1])[::-1]
            neg_ge = np.cumsum(self._neg_hist[::-1])[::-1]
            total = pos_ge + neg_ge
            # precision=1 for thresholds above every score (nothing predicted
            # positive) — same anchor convention as the exact path below
            precision = np.where(total == 0, 1.0,
                                 pos_ge / np.maximum(total, 1))
            recall = pos_ge / max(self._pos_hist.sum(), 1)
            # ascending recall, anchored at (recall=0, precision=1)
            recall = np.concatenate([[0.0], recall[::-1]])
            precision = np.concatenate([[1.0], precision[::-1]])
            return float(np.trapezoid(precision, recall))
        s, y = self._collect()
        order = np.argsort(-s, kind="mergesort")
        y = y[order] > 0.5
        tp = np.cumsum(y)
        fp = np.cumsum(~y)
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / max(y.sum(), 1)
        # prepend (recall=0, precision=1)
        recall = np.concatenate([[0.0], recall])
        precision = np.concatenate([[1.0], precision])
        return float(np.trapezoid(precision, recall))

    def merge(self, other: "ROC"):
        """reference ROC.merge (distributed aggregation). Exact mode
        concatenates retained arrays; thresholded mode adds histograms."""
        if self.threshold_steps != other.threshold_steps:
            raise ValueError("Cannot merge ROCs with different threshold_steps")
        if self.threshold_steps > 0:
            self._pos_hist += other._pos_hist
            self._neg_hist += other._neg_hist
        else:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)
        return self

    def to_json(self) -> str:
        """The accumulated pairs (exact mode) or histograms (thresholded)
        as JSON (``from_json`` reads it)."""
        d = {"threshold_steps": self.threshold_steps}
        if self.threshold_steps > 0:
            d.update(pos_hist=self._pos_hist.tolist(), neg_hist=self._neg_hist.tolist())
        else:
            s, y = self._collect() if self._scores else (np.zeros(0), np.zeros(0))
            d.update(scores=s.tolist(), labels=y.tolist())
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "ROC":
        d = json.loads(s)
        roc = ROC(d["threshold_steps"])
        if roc.threshold_steps > 0:
            roc._pos_hist = np.asarray(d["pos_hist"], np.int64)
            roc._neg_hist = np.asarray(d["neg_hist"], np.int64)
        elif d["scores"]:
            roc._scores = [np.asarray(d["scores"], np.float64)]
            roc._labels = [np.asarray(d["labels"], np.float64)]
        return roc

    def get_roc_curve(self, num_points: int = 101):
        """(fpr, tpr) arrays at score thresholds (reference curves/RocCurve)."""
        if self.threshold_steps > 0:
            _, fpr, tpr = self._thresholded_rates()
            return fpr[::-1], tpr[::-1]
        s, y = self._collect()
        thresholds = np.linspace(1.0, 0.0, num_points)
        pos = max((y > 0.5).sum(), 1)
        neg = max((y <= 0.5).sum(), 1)
        tpr = [(s[y > 0.5] >= t).sum() / pos for t in thresholds]
        fpr = [(s[y <= 0.5] >= t).sum() / neg for t in thresholds]
        return np.asarray(fpr), np.asarray(tpr)

    def export_roc_curve(self, num_points: int = 101) -> "RocCurve":
        """Exportable curve object (reference ROC.getRocCurve -> RocCurve)."""
        from deeplearning4j_tpu_torch.eval.curves import RocCurve
        if self.threshold_steps > 0:
            thresholds, fpr, tpr = self._thresholded_rates()
            return RocCurve(thresholds=[float(t) for t in thresholds],
                            fpr=[float(v) for v in fpr],
                            tpr=[float(v) for v in tpr])
        thresholds = np.linspace(1.0, 0.0, num_points)
        fpr, tpr = self.get_roc_curve(num_points)
        return RocCurve(thresholds=[float(t) for t in thresholds],
                        fpr=[float(v) for v in fpr],
                        tpr=[float(v) for v in tpr])

    def export_precision_recall_curve(self, num_points: int = 101) -> "PrecisionRecallCurve":
        """reference ROC.getPrecisionRecallCurve -> PrecisionRecallCurve."""
        from deeplearning4j_tpu_torch.eval.curves import PrecisionRecallCurve
        if self.threshold_steps > 0:
            thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
            pos_ge = np.concatenate([np.cumsum(self._pos_hist[::-1])[::-1], [0]])
            neg_ge = np.concatenate([np.cumsum(self._neg_hist[::-1])[::-1], [0]])
            total = pos_ge + neg_ge
            # precision=1 where nothing is predicted positive (reference
            # PrecisionRecallCurve zero-recall anchor), keeping the exported
            # curve's AUPRC consistent with calculate_auprc()
            prec = np.where(total == 0, 1.0, pos_ge / np.maximum(total, 1))
            rec = pos_ge / max(self._pos_hist.sum(), 1)
            return PrecisionRecallCurve(
                thresholds=[float(t) for t in thresholds],
                precision=[float(v) for v in prec],
                recall=[float(v) for v in rec])
        s, y = self._collect()
        thresholds = np.linspace(0.0, 1.0, num_points)
        ypos = y > 0.5
        npos = max(ypos.sum(), 1)
        prec, rec = [], []
        for t in thresholds:
            sel = s >= t
            tp = (ypos & sel).sum()
            prec.append(float(tp / sel.sum()) if sel.sum() else 1.0)
            rec.append(float(tp / npos))
        return PrecisionRecallCurve(thresholds=[float(t) for t in thresholds],
                                    precision=prec, recall=rec)


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = as_host(labels)
        preds = as_host(predictions)
        n = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n)]
        lab2 = labels.reshape(-1, n)
        pr2 = preds.reshape(-1, n)
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            lab2, pr2 = lab2[m], pr2[m]
        for i in range(n):
            self._rocs[i].eval(lab2[:, i], pr2[:, i])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def merge(self, other: "ROCMultiClass"):
        """reference ROCMultiClass.merge: delegate per class."""
        if other._rocs is None:
            return self
        if self._rocs is None:
            self._rocs = [ROC() for _ in other._rocs]
        if len(self._rocs) != len(other._rocs):
            raise ValueError(
                f"Cannot merge {len(other._rocs)}-class into "
                f"{len(self._rocs)}-class ROCMultiClass")
        for mine, theirs in zip(self._rocs, other._rocs):
            mine.merge(theirs)
        return self

    def calculate_average_auc(self) -> float:
        vals = [r.calculate_auc() for r in self._rocs]
        vals = [v for v in vals if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")


class ROCBinary:
    """Independent binary ROC per output column, for multi-label sigmoid
    outputs (reference eval/ROCBinary.java:43). Differs from ROCMultiClass
    in that columns are independent binary problems, not one-vs-all over a
    softmax."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = as_host(labels)
        preds = as_host(predictions)
        n = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in range(n)]
        elif n != len(self._rocs):
            raise ValueError(
                f"Batch has {n} outputs; previous batches had {len(self._rocs)}")
        lab2 = labels.reshape(-1, n)
        pr2 = preds.reshape(-1, n)
        if mask is not None:
            m = as_host(mask).reshape(-1).astype(bool)
            lab2, pr2 = lab2[m], pr2[m]
        for i in range(n):
            self._rocs[i].eval(lab2[:, i], pr2[:, i])

    def num_outputs(self) -> int:
        return 0 if self._rocs is None else len(self._rocs)

    def calculate_auc(self, output: int) -> float:
        return self._rocs[output].calculate_auc()

    def calculate_auprc(self, output: int) -> float:
        return self._rocs[output].calculate_auprc()

    def merge(self, other: "ROCBinary"):
        """reference ROCBinary.merge: delegate per output column."""
        if other._rocs is None:
            return self
        if self.threshold_steps != other.threshold_steps:
            raise ValueError("Cannot merge ROCBinary with different "
                             "threshold_steps")
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in other._rocs]
        if len(self._rocs) != len(other._rocs):
            raise ValueError(
                f"Cannot merge {len(other._rocs)}-output into "
                f"{len(self._rocs)}-output ROCBinary")
        for mine, theirs in zip(self._rocs, other._rocs):
            mine.merge(theirs)
        return self

    def calculate_average_auc(self) -> float:
        vals = [r.calculate_auc() for r in self._rocs]
        vals = [v for v in vals if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")
