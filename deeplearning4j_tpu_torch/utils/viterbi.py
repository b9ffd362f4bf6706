"""Viterbi label-sequence smoothing.

Parity surface: reference ``deeplearning4j-nn/.../util/Viterbi.java`` (decode
a noisy label sequence under a metastable markov prior: emission accuracy
``p_correct``, self-transition probability ``meta_stability``; decode() takes
a binary label matrix or raw outcome indices and returns (log-likelihood,
smoothed sequence)).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


class Viterbi:
    def __init__(self, possible_labels: Sequence, meta_stability: float = 0.9,
                 p_correct: float = 0.99):
        self.possible_labels = np.asarray(possible_labels)
        self.states = int(len(self.possible_labels))
        if self.states < 2:
            raise ValueError("Need at least 2 states")
        self.meta_stability = meta_stability
        self.p_correct = p_correct
        # emission: observed == state with p_correct, else uniform leak
        self._log_emit_same = math.log(p_correct)
        self._log_emit_diff = math.log((1.0 - p_correct) / (self.states - 1))
        # transition: stay with meta_stability, else uniform leak
        self._log_stay = math.log(meta_stability)
        self._log_move = math.log((1.0 - meta_stability) / (self.states - 1))

    def decode(self, labels, binary_label_matrix: bool = True
               ) -> Tuple[float, np.ndarray]:
        """(log-likelihood, smoothed outcome sequence). ``labels`` is a
        (T, states) one-hot matrix (default) or a (T,) outcome vector."""
        labels = np.asarray(labels)
        if binary_label_matrix and labels.ndim == 2:
            observed = np.argmax(labels, axis=1)
        else:
            observed = labels.reshape(-1).astype(np.int64)
        T, S = len(observed), self.states
        emit = np.full((T, S), self._log_emit_diff)
        emit[np.arange(T), observed] = self._log_emit_same
        trans = np.full((S, S), self._log_move)
        np.fill_diagonal(trans, self._log_stay)
        # DP
        v = -math.log(S) + emit[0]
        back = np.zeros((T, S), np.int64)
        for t in range(1, T):
            scores = v[:, None] + trans          # (from, to)
            back[t] = np.argmax(scores, axis=0)
            v = scores[back[t], np.arange(S)] + emit[t]
        path = np.zeros(T, np.int64)
        path[-1] = int(np.argmax(v))
        for t in range(T - 1, 0, -1):
            path[t - 1] = back[t, path[t]]
        return float(v.max()), self.possible_labels[path]
