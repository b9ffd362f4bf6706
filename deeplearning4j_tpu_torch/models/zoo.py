"""Model zoo base (counterpart of ``deeplearning4j_tpu/models/zoo.py``).

``conf()`` builds the network configuration; ``init(device=...)`` returns a
network with weights drawn from a ``torch.Generator`` seeded with the zoo
model's seed. Pretrained weights are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple


class ZooModel:
    def __init__(self, num_classes: int = 1000, seed: int = 12345,
                 input_shape: Optional[Tuple[int, ...]] = None):
        self.num_classes = num_classes
        self.seed = seed
        if input_shape is not None:
            self.input_shape = input_shape

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build and initialize on ``device`` (the port's device rule): a
        ``MultiLayerNetwork`` or a ``ComputationGraph``, as the
        configuration is. The JAX package's ``fold_bn=`` serving build is
        not ported."""
        from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
        from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        c = self.conf()
        if isinstance(c, MultiLayerConfiguration):
            return MultiLayerNetwork(c, device).init()
        if isinstance(c, ComputationGraphConfiguration):
            return ComputationGraph(c, device).init()
        raise TypeError(type(c))
