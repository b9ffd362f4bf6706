"""PyTorch/CUDA port of deeplearning4j_tpu for NVIDIA Hopper (H100).

A second package beside ``deeplearning4j_tpu``, with the same module paths,
public names, configuration JSON and tensor layouts. It imports torch,
numpy and the standard library only. Every entry point runs on ``cuda``
unless the caller passes ``device="cpu"`` (``device.py``).

Ported so far:

- serving: int4-quantized ``MultiLayerNetwork`` inference through
  ``ParallelInference``, with the int4 dot product in a hand-written CUDA
  kernel (``perf/kernels/int4_dot.py``, ``csrc/int4_dot.cu``);
- training: ``ComputationGraph.fit`` (ResNet50 in bf16 with float32 master
  weights), with the fused conv→BN→activation block's batch norm in the
  hand-written ``bn_act_fwd`` / ``bn_act_bwd`` CUDA kernels
  (``perf/kernels/bn_act.py``, ``csrc/bn_act_fwd.cu``, ``csrc/bn_act_bwd.cu``);
- retrieval: ``PQIndex`` / ``IVFPQIndex`` / int4 ``BruteForceIndex`` built on
  the card and served by ``IndexEndpoint``, with the ADC gather-accumulate in
  the ``adc_pq`` / ``adc_ivf_pq`` kernels (``perf/kernels/adc.py``) and the
  int4 table through ``int4_dot``;
- NLP: ``Word2Vec`` / ``ParagraphVectors`` / ``Glove`` training
  (``nlp/``), with every embedding-table update in the ordered
  ``scatter_add`` kernel (``perf/kernels/scatter_add.py``,
  ``csrc/scatter_add.cu``).
"""

from deeplearning4j_tpu_torch.nn.conf import (InputType, MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["InputType", "MultiLayerConfiguration", "NeuralNetConfiguration",
           "MultiLayerNetwork", "ComputationGraphConfiguration", "ComputationGraph"]
