"""Load a model from a file of unknown provenance (counterpart of
``deeplearning4j_tpu/utils/model_guesser.py``; reference
``ModelGuesser.java``: ``loadModelGuess``, ``loadConfigGuess``).

The framework's own zip is restored by ``utils/serialization.py``; anything
else is imported as a Keras file (``modelimport/``: a Keras 3 ``.keras`` zip
or an HDF5 file), and a file that neither reads raises ``ValueError`` naming
both formats.
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
    ModelGuesser.loadModelGuess :114) onto ``device``: the framework's own
    zip (metadata.json + configuration.json), a Keras 3 ``.keras`` zip, or a
    Keras HDF5 file."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
        if "metadata.json" in names and "configuration.json" in names:
            from deeplearning4j_tpu_torch.utils.serialization import restore
            return restore(path, device=device)
    # anything else is a Keras format — import_keras_model's archive opener
    # already dispatches .keras zips vs HDF5 and validates both
    from deeplearning4j_tpu_torch.modelimport import (KerasImportError,
                                                      import_keras_model)
    try:
        return import_keras_model(path, device=device)
    except (KerasImportError, OSError) as e:
        raise ValueError(
            f"Cannot guess the model format of {path!r}: neither a "
            f"framework model zip nor a Keras file ({e})") from e
