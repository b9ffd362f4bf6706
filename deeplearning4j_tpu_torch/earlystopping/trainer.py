"""Early-stopping trainer (counterpart of
``deeplearning4j_tpu/earlystopping/trainer.py``: the same epochs, scores,
termination and best epoch for the same network and data).

Parity surface: reference earlystopping/EarlyStoppingConfiguration.java,
trainer/BaseEarlyStoppingTrainer.java: per-epoch score on a validation set,
best-model tracking via a saver, iteration + epoch termination conditions.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import List

from deeplearning4j_tpu_torch.earlystopping.conditions import (
    EpochTerminationCondition, IterationTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.savers import InMemoryModelSaver
from deeplearning4j_tpu_torch.perf.prefetch import DevicePrefetchIterator

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition]
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        dataclasses.field(default_factory=list)
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str  # "epoch_condition" | "iteration_condition" | "error"
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: object


class EarlyStoppingTrainer:
    """Drive fit() epoch-by-epoch with validation scoring (see module doc).

    ``score_calculator``: callable(model) -> float; defaults to loss on the
    validation iterator (reference scorecalc/DataSetLossCalculator.java).

    ``checkpoint_manager`` (checkpoint.CheckpointManager) plugs the
    checkpoint/ subsystem in as the saver backend: best/latest models
    become durable, checksummed, retention-bounded checkpoints (the
    manager implements the saver protocol — save_best_model /
    save_latest_model / get_best_model via restore_best). Passing one
    overrides ``config.model_saver``. The manager's ``storage=`` backend
    carries through unchanged — a manager built over
    ``RetryingBackend(ObjectStoreBackend(...))`` gives early stopping
    object-store durability with transient-fault retries for free, and
    ``get_best_model`` inherits restore_best's corruption fallback
    (next-best checkpoint, never garbage).

    Each epoch's training batches pass through
    ``perf/prefetch.py::DevicePrefetchIterator`` to the model's device, so
    batch N+1's copy overlaps step N (what ``fit(prefetch=True)`` does, for
    the batch-at-a-time loop here; the math is the same as without it).
    """

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_data, validation_data=None, score_calculator=None,
                 checkpoint_manager=None):
        if checkpoint_manager is not None:
            config = dataclasses.replace(config,
                                         model_saver=checkpoint_manager)
        self.config = config
        self.model = model
        self.train_data = train_data
        self.validation_data = validation_data
        if score_calculator is None:
            if validation_data is None:
                raise ValueError("Need validation_data or a score_calculator")

            def score_calculator(m):
                total, n = 0.0, 0
                for ds in self.validation_data:
                    total += m.score_dataset(ds) * ds.num_examples()
                    n += ds.num_examples()
                return total / max(n, 1)
        self.score_calculator = score_calculator

    def _fit_batch(self, ds) -> bool:
        """One training batch; returns whether the batch actually trained.
        Overridden by the parallel trainer to route through a
        ParallelWrapper (which may drop ragged batches)."""
        self.model.fit(ds)
        return True

    def fit(self) -> EarlyStoppingResult:
        for c in (self.config.epoch_termination_conditions
                  + self.config.iteration_termination_conditions):
            c.initialize()
        best_score = math.inf
        best_epoch = -1
        score_vs_epoch = {}
        last_computed_score = math.inf
        epoch = 0
        reason, details = "epoch_condition", ""
        while True:
            # --- one epoch of training with iteration-condition checks ---
            stop_iter = None
            trained_any = False
            for ds in DevicePrefetchIterator(self.train_data, device=self.model.device):
                if self._fit_batch(ds) is not False:
                    trained_any = True
                if not self.config.iteration_termination_conditions:
                    continue
                # a host read of the step's loss: only when a condition
                # reads it, else the host would wait on every step
                s = self.model.score()
                for cond in self.config.iteration_termination_conditions:
                    if cond.terminate(s):
                        stop_iter = cond
                        break
                if stop_iter is not None:
                    break
            if not trained_any:
                raise ValueError(
                    "No training batch was usable this epoch (empty data, or "
                    "every batch dropped as ragged by the parallel wrapper)")
            if stop_iter is not None:
                reason = "iteration_condition"
                details = type(stop_iter).__name__
                break
            # --- validation scoring (every N epochs) ---
            score = None
            if epoch % self.config.evaluate_every_n_epochs == 0:
                score = float(self.score_calculator(self.model))
                score_vs_epoch[epoch] = score
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    self.config.model_saver.save_best_model(self.model, score)
                if self.config.save_last_model:
                    self.config.model_saver.save_latest_model(self.model, score)
            # --- epoch termination (reference BaseEarlyStoppingTrainer):
            # score-free conditions every epoch; score-based conditions only
            # on epochs where a validation score was actually computed, so
            # patience counters tick per evaluation, not per epoch ---
            if score is not None:
                last_computed_score = score
            stop_epoch = None
            for cond in self.config.epoch_termination_conditions:
                if getattr(cond, "requires_score", True) and score is None:
                    continue
                if cond.terminate(epoch, last_computed_score):
                    stop_epoch = cond
                    break
            if stop_epoch is not None:
                details = type(stop_epoch).__name__
                epoch += 1
                break
            epoch += 1
        best_model = self.config.model_saver.get_best_model(self.model)
        if best_model is None and best_epoch >= 0:
            # a best model WAS saved but the saver cannot hand it back
            # (every checkpoint torn/corrupt, or the store lost them):
            # degrade to the live in-memory model rather than returning
            # None for a run that demonstrably trained — loudly, because
            # the live model is the LAST state, not the best-scoring one
            log.warning(
                "model saver could not return the saved best model (epoch "
                "%d, score %.6g) — storage fault or pruned checkpoint; "
                "falling back to the live final-state model", best_epoch,
                best_score)
            best_model = self.model
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            score_vs_epoch=score_vs_epoch,
            best_model=best_model,
        )
