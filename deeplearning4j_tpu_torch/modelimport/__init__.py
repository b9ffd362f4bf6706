"""Keras model import (reference deeplearning4j-modelimport, 11.3k LoC;
counterpart of ``deeplearning4j_tpu/modelimport/``).

Public API mirrors ``keras/KerasModelImport.java:41``:

- :func:`import_keras_sequential_model_and_weights` -> MultiLayerNetwork
- :func:`import_keras_model_and_weights`            -> ComputationGraph
- :func:`import_keras_model` — auto-detects sequential vs functional
- :func:`register_keras_layer` — custom-layer hook
  (reference KerasLayer.registerCustomLayer — keras/KerasLayer.java:149)
"""

from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError,
    import_keras_model,
    import_keras_model_and_weights,
    import_keras_sequential_model_and_weights,
)
from deeplearning4j_tpu_torch.modelimport.keras_layers import register_keras_layer

__all__ = [
    "Hdf5Archive",
    "KerasImportError",
    "import_keras_model",
    "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
    "register_keras_layer",
]
