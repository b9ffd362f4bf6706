"""Model savers for early stopping (counterpart of
``deeplearning4j_tpu/earlystopping/savers.py``).

Parity surface: reference earlystopping/saver/{InMemoryModelSaver,
LocalFileModelSaver,LocalFileGraphSaver}.java.

The port updates its masters in place, so ``InMemoryModelSaver`` keeps a
copy of every tensor (on the network's device), never a reference: the
saved best model must not follow later steps. ``LocalFileModelSaver``
writes model zips through ``utils/serialization.py`` and restores them on
the template's device.
"""

from __future__ import annotations

import os

import torch

from deeplearning4j_tpu_torch.nn.tree import tree_map


def _clone_tree(tree):
    return tree_map(lambda v: v.detach().clone() if isinstance(v, torch.Tensor) else v, tree)


def _clone_model(template):
    """Fresh model object of the template's class, configuration and
    device (parameters overwritten by the caller): get_best_model must not
    mutate the live training model."""
    model = type(template)(template.conf, template.device)
    model.init()
    model.set_augmentation(template.augmentation)
    return model


class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    @staticmethod
    def _snapshot(model):
        return (_clone_tree(model.params), _clone_tree(model.state))

    def save_best_model(self, model, score):
        self._best = (self._snapshot(model), score)

    def save_latest_model(self, model, score):
        self._latest = (self._snapshot(model), score)

    def get_best_model(self, template):
        if self._best is None:
            return None
        (params, state), _ = self._best
        model = _clone_model(template)
        model.set_params(_clone_tree(params), _clone_tree(state))
        return model


class LocalFileModelSaver:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def save_best_model(self, model, score):
        from deeplearning4j_tpu_torch.utils.serialization import write_model
        write_model(model, self._path("bestModel.zip"))

    def save_latest_model(self, model, score):
        from deeplearning4j_tpu_torch.utils.serialization import write_model
        write_model(model, self._path("latestModel.zip"))

    def get_best_model(self, template=None):
        from deeplearning4j_tpu_torch.utils.serialization import restore
        path = self._path("bestModel.zip")
        if not os.path.exists(path):
            return None
        return restore(path, device=None if template is None else template.device)
