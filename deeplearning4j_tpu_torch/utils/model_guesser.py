"""Load a model from a file of unknown provenance (counterpart of
``deeplearning4j_tpu/utils/model_guesser.py``; reference
``ModelGuesser.java``: ``loadModelGuess``, ``loadConfigGuess``).

The framework's own zip is restored by ``utils/serialization.py``; a Keras
file raises ``NotImplementedError`` until ``modelimport/`` is ported
(ROADMAP §A7).
"""

from __future__ import annotations

import json
import os
import zipfile


def load_config_guess(source: str):
    """Parse a config that may be a MultiLayerConfiguration or a
    ComputationGraphConfiguration (reference ModelGuesser.loadConfigGuess).
    ``source`` is a JSON string or a path to one."""
    from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
    if os.path.exists(source):
        with open(source, "r", encoding="utf-8") as f:
            source = f.read()
    elif not source.lstrip().startswith("{"):
        raise ValueError(f"No such configuration file: {source!r}")
    d = json.loads(source)
    if "vertices" in d or "network_inputs" in d:
        return ComputationGraphConfiguration.from_json(source)
    if "layers" in d:
        return MultiLayerConfiguration.from_json(source)
    raise ValueError("Unrecognized configuration JSON: neither a layer list "
                     "nor a graph (no 'layers'/'vertices' key)")


def load_model_guess(path: str, device=None):
    """Load a model whose format is unknown (reference
    ModelGuesser.loadModelGuess): the framework's own zip (metadata.json +
    configuration.json) on ``device``; anything else would be a Keras file."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
        if "metadata.json" in names and "configuration.json" in names:
            from deeplearning4j_tpu_torch.utils.serialization import restore
            return restore(path, device=device)
    raise NotImplementedError(
        f"{path!r} is not a framework model zip; Keras import (modelimport/) is not "
        "in the PyTorch port yet (ROADMAP §A7)")
