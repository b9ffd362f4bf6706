"""ML-pipeline integration: scikit-learn-compatible estimators (counterpart
of ``deeplearning4j_tpu/mlpipeline.py``).

Parity surface: reference dl4j-spark-ml
(``deeplearning4j-scaleout/spark/dl4j-spark-ml/src/main/java/org/deeplearning4j/
spark/ml/impl/SparkDl4jNetwork.java:1`` — an Estimator whose ``fit(DataFrame)``
returns a Transformer model usable inside Spark ML Pipelines, plus the
AutoEncoder variant). The JVM-side Spark ML fabric is scoped out (README);
the CAPABILITY — drop a network into the ecosystem's standard pipeline/
grid-search machinery — maps in Python to the scikit-learn estimator
contract, which is what these wrappers implement:

* duck-typed ``get_params``/``set_params``/``fit``/``predict`` — works with
  ``sklearn.pipeline.Pipeline``, ``GridSearchCV``, ``cross_val_score``,
  ``clone`` without importing sklearn here: the estimators inherit no
  sklearn class, and ``__sklearn_tags__`` (which sklearn >= 1.6 asks of
  every estimator) imports sklearn only when sklearn calls it;
* each ``fit`` builds a FRESH network from the configuration (sklearn's
  re-fit semantics) on the estimator's ``device`` (the port's device rule:
  ``cuda`` unless ``device="cpu"``; a constructor parameter, so ``clone``
  and ``get_params`` carry it), trains it minibatch-wise, and exposes the
  live network as ``model_``. Predictions come back as numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class _BaseDL4JEstimator:
    """sklearn-contract plumbing shared by the classifier/regressor."""

    _estimator_type = None  # "classifier" / "regressor" (sklearn's is_classifier)

    _PARAM_NAMES = ("conf", "epochs", "batch_size", "shuffle", "seed", "device")

    def __init__(self, conf=None, epochs: int = 10, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 12345, device=None):
        self.conf = conf
        self.epochs = epochs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = device

    # ------------------------------------------------------ sklearn contract
    def get_params(self, deep: bool = True):
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self._PARAM_NAMES:
                raise ValueError(
                    f"Invalid parameter {k!r} for {type(self).__name__}; "
                    f"valid: {self._PARAM_NAMES}")
            setattr(self, k, v)
        return self

    def __sklearn_tags__(self):
        from sklearn.utils import ClassifierTags, RegressorTags, Tags, TargetTags
        clf = self._estimator_type == "classifier"
        return Tags(estimator_type=self._estimator_type,
                    target_tags=TargetTags(required=True),
                    classifier_tags=ClassifierTags() if clf else None,
                    regressor_tags=None if clf else RegressorTags())

    # ----------------------------------------------------------------- fit
    def _build(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import (
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        conf = self.conf() if callable(self.conf) else self.conf
        if conf is None:
            raise ValueError(
                f"{type(self).__name__} needs a network configuration: pass "
                "conf=<MultiLayerConfiguration or zero-arg factory>")
        if isinstance(conf, MultiLayerConfiguration):
            return MultiLayerNetwork(conf, self.device).init(self.seed)
        if isinstance(conf, ComputationGraphConfiguration):
            return ComputationGraph(conf, self.device).init(self.seed)
        raise TypeError(f"Unsupported configuration type {type(conf)}")

    def _fit_arrays(self, X, Y):
        net = self._build()
        X = np.asarray(X, np.float32)
        Y = np.asarray(Y, np.float32)
        rng = np.random.default_rng(self.seed)
        n = len(X)
        for _ in range(int(self.epochs)):
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for s in range(0, n, int(self.batch_size)):
                idx = order[s:s + int(self.batch_size)]
                net.fit(DataSet(X[idx], Y[idx]))
        self.model_ = net
        self.n_features_in_ = X.shape[1] if X.ndim == 2 else X.shape[1:]
        return self

    def _check_fitted(self):
        if not hasattr(self, "model_"):
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet; call fit first")

    def _output(self, X) -> np.ndarray:
        """(n, out) network output for MLN and single-input graphs alike
        (ComputationGraph.output returns a LIST of output arrays)."""
        m = self.model_
        X = np.asarray(X, np.float32)
        out = m.output_single(X) if hasattr(m, "output_single") else m.output(X)
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        return np.asarray(out)


class DL4JClassifier(_BaseDL4JEstimator):
    """Classifier estimator (reference SparkDl4jNetwork classification use).

    ``y`` may be integer class labels or one-hot rows; classes are stored in
    ``classes_`` and predictions are mapped back to the original labels.

    Example::

        clf = DL4JClassifier(conf=my_conf_factory, epochs=30)
        clf.fit(X, y).predict(X2)                 # sklearn semantics
        Pipeline([("scale", StandardScaler()), ("net", clf)]).fit(X, y)
    """

    _estimator_type = "classifier"

    def fit(self, X, y):
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] > 1:          # one-hot given
            self.classes_ = np.arange(y.shape[1])
            onehot = y.astype(np.float32)
        else:
            self.classes_, inv = np.unique(y.ravel(), return_inverse=True)
            onehot = np.eye(len(self.classes_), dtype=np.float32)[inv]
        return self._fit_arrays(X, onehot)

    def predict_proba(self, X) -> np.ndarray:
        self._check_fitted()
        return self._output(X)

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return self.classes_[np.argmax(self.predict_proba(X), axis=-1)]

    def score(self, X, y) -> float:
        """Mean accuracy (sklearn classifier contract); accepts the same
        label formats as fit (integer/str labels or one-hot rows)."""
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] > 1:
            y = self.classes_[np.argmax(y, axis=-1)]
        else:
            y = y.ravel()
        return float(np.mean(self.predict(X) == y))


class DL4JRegressor(_BaseDL4JEstimator):
    """Regressor estimator (reference SparkDl4jNetwork regression use)."""

    _estimator_type = "regressor"

    def fit(self, X, y):
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self._y_cols = y.shape[1]
        return self._fit_arrays(X, y)

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        out = self._output(X)
        return out.ravel() if self._y_cols == 1 else out

    def score(self, X, y) -> float:
        """R^2 (sklearn regressor contract)."""
        y = np.asarray(y, np.float32)
        pred = self.predict(X)
        ss_res = float(np.sum((y.ravel() - pred.ravel()) ** 2))
        ss_tot = float(np.sum((y.ravel() - np.mean(y)) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-12)


__all__ = ["DL4JClassifier", "DL4JRegressor"]
