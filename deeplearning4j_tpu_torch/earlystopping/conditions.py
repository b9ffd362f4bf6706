"""Early-stopping termination conditions.

Parity surface: reference earlystopping/termination/ (6 conditions):
MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
MaxTimeIterationTerminationCondition, ScoreImprovementEpochTerminationCondition,
InvalidScoreIterationTerminationCondition (doubles as NaN/divergence guard),
BestScoreEpochTerminationCondition.
"""

from __future__ import annotations

import math
import time


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class EpochTerminationCondition:
    # Conditions that read the validation score are only checked on epochs
    # where one was computed (evaluate_every_n_epochs); score-free conditions
    # (max epochs) are checked every epoch.
    requires_score = True

    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    requires_score = False

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target."""

    def __init__(self, best_expected: float):
        self.best_expected = best_expected

    def terminate(self, epoch, score):
        return score <= self.best_expected


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.max_no_improve = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = math.inf
        self.since = 0

    def initialize(self):
        self.best = math.inf
        self.since = 0

    def terminate(self, epoch, score):
        if self.best - score > self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since > self.max_no_improve


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop immediately if the score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """NaN/Inf guard (reference InvalidScoreIterationTerminationCondition.java;
    the reference's divergence-detection story — SURVEY §5)."""

    def terminate(self, score):
        return math.isnan(score) or math.isinf(score)


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score):
        if self._start is None:
            self._start = time.monotonic()
        return time.monotonic() - self._start > self.max_seconds
