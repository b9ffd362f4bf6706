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
  ``csrc/scatter_add.cu``);
- attention: causal transformer LMs served through ``ParallelInference``
  and trained through ``MultiLayerNetwork.fit`` (float32, or bf16 with
  float32 masters), with the attention in the flash kernels: forward
  ``csrc/flash_attn_fwd.cu``, backward ``csrc/flash_attn_bwd_dkv.cu`` and
  ``csrc/flash_attn_bwd_dq.cu``, behind a ``torch.autograd.Function``
  (``perf/kernels/flash_attention.py``);
- parallelism (``parallel/``): data-parallel, tensor-parallel, pipelined
  and elastic training over ``torch.distributed``, ring and Ulysses
  attention; at a data world above 1 the bn kernels run as split launches
  around the all-reduce; the serving fleet (``fleet/``) routes over
  replicas of ``ModelServer``;
- the training UI and Keras import: ``StatsListener`` (statistics reduced
  on the card) into ``storage/`` and the dashboard ``UIServer`` (``ui/``),
  ``modelimport/`` (Keras HDF5 and ``.keras`` models into networks on the
  card, whose fused blocks train through the bn kernels), and the
  sklearn-contract estimators (``mlpipeline.py``).
"""

from deeplearning4j_tpu_torch.nn.conf import (InputType, MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["InputType", "MultiLayerConfiguration", "NeuralNetConfiguration",
           "MultiLayerNetwork", "ComputationGraphConfiguration", "ComputationGraph"]
