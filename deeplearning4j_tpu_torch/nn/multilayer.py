"""MultiLayerNetwork — the sequential-stack network, inference side
(counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``, the
inference branch of ``_forward``, ``output``, ``predict``, ``feed_forward``).

Parameters are a list of per-layer dicts of tensors in the JAX package's
layouts, so ``interop.params_from_jax`` can hand over a JAX network's
weights leaf for leaf; ``state`` is the list of per-layer buffer dicts
(batch-norm running stats). Training a ``MultiLayerNetwork`` is not in the
port yet: ``ComputationGraph`` trains. PyTorch runs eagerly: there is no compiled program
per shape, and ``output`` returns a tensor on the network's device without
waiting for it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration


class MultiLayerNetwork:
    """Sequential network. ``device`` follows the port's device rule:
    ``cuda`` unless the caller passes ``device="cpu"``."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.device = resolve_device(device)
        if conf.dtype != "float32":
            raise NotImplementedError(
                f"dtype '{conf.dtype}': this slice of the port serves float32 "
                "networks only; reduced-precision compute comes with training")
        self.conf = conf
        self.layers = conf.wired_layers()
        self._pre = conf.resolved_preprocessors()
        if not self.layers:
            raise ValueError("Empty layer list")
        self.params: Optional[List[dict]] = None
        self.state: List[dict] = [{} for _ in self.layers]

    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Draw every layer's parameters from one ``torch.Generator`` on the
        network's device, seeded with ``conf.seed`` (or ``seed``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.conf.seed if seed is None else int(seed))
        types = self.conf.layer_input_types()
        ps = [layer.init(gen, it, self.device)
              for layer, it in zip(self.layers, types)]
        self.params = [p for p, _ in ps]
        self.state = [s for _, s in ps]
        return self

    def to(self, device) -> "MultiLayerNetwork":
        """A new network on ``device`` with copies of these parameters."""
        out = MultiLayerNetwork(self.conf, device)
        out.params, out.state = ([{k: v.to(out.device, copy=True)
                                   for k, v in p.items()} for p in tree]
                                 for tree in (self.params, self.state))
        return out

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Inference forward; returns every layer's activation."""
        acts = []
        for i, layer in enumerate(self.layers):
            if i in self._pre:
                x = self._pre[i].apply(x)
            x, _ = layer.apply(self.params[i], self.state[i], x)
            acts.append(x)
        return acts

    @torch.inference_mode()
    def output(self, x) -> torch.Tensor:
        """Inference forward pass (reference MultiLayerNetwork.output)."""
        if self.params is None:
            self.init()
        return self._forward(self._as_input(x))[-1]

    def predict(self, x) -> np.ndarray:
        """Class indices (reference MultiLayerNetwork.predict)."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations (reference feedForward)."""
        return self._forward(self._as_input(x))
