"""Model zoo base (counterpart of ``deeplearning4j_tpu/models/zoo.py``).

``conf()`` builds the network configuration; ``init(device=...)`` returns a
network with weights drawn from a ``torch.Generator`` seeded with the zoo
model's seed, and ``init(fold_bn=True)`` its BN-folded serving build.
``init_pretrained`` restores a model zip from a local directory
(``DL4J_TPU_PRETRAINED_DIR``): the port downloads nothing.
"""

from __future__ import annotations

import os
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

    def init(self, device=None, fold_bn: bool = False):
        """Build and initialize on ``device`` (the port's device rule): a
        ``MultiLayerNetwork`` or a ``ComputationGraph``, as the
        configuration is. ``fold_bn=True`` returns the serving build, every
        foldable BatchNormalization folded into its conv
        (``perf.fusion.fold_bn``): not trainable, its running stats gone."""
        from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
        from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        c = self.conf()
        if isinstance(c, MultiLayerConfiguration):
            net = MultiLayerNetwork(c, device).init()
        elif isinstance(c, ComputationGraphConfiguration):
            net = ComputationGraph(c, device).init()
        else:
            raise TypeError(type(c))
        if fold_bn:
            from deeplearning4j_tpu_torch.perf.fusion import fold_bn as _fold_bn
            net = _fold_bn(net)
        return net

    def pretrained_checkpoint(self) -> Optional[str]:
        """``<DL4J_TPU_PRETRAINED_DIR>/<model name>.zip`` where it exists."""
        d = os.environ.get("DL4J_TPU_PRETRAINED_DIR")
        if not d:
            return None
        path = os.path.join(d, f"{type(self).__name__.lower()}.zip")
        return path if os.path.exists(path) else None

    def init_pretrained(self, device=None):
        """The pretrained network from the local directory (the JAX
        package's zip format, ``utils/serialization.restore``)."""
        from deeplearning4j_tpu_torch.utils.serialization import restore
        path = self.pretrained_checkpoint()
        if path is None:
            raise FileNotFoundError(
                f"No pretrained weights for {type(self).__name__}: set "
                "DL4J_TPU_PRETRAINED_DIR to a directory holding "
                f"{type(self).__name__.lower()}.zip")
        return restore(path, device=device)
