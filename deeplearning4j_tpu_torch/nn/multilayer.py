"""MultiLayerNetwork — the sequential-stack network, inference side
(counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``, the
inference branch of ``_forward`` with its features mask, ``output``,
``predict``, ``feed_forward``).

Parameters are a list of per-layer dicts of tensors in the JAX package's
layouts (nested, for the attention layers' ``q``/``k``/``v``/``o``
groups), so ``interop.params_from_jax`` can hand over a JAX network's
weights leaf for leaf; ``state`` is the list of per-layer buffer dicts
(batch-norm running stats). Inputs are taken as float32, token ids
included: float32 holds every id below 2**24 exactly, and the embedding
layers cast them to long. Training a ``MultiLayerNetwork`` is not in the
port yet: ``ComputationGraph`` trains. PyTorch runs eagerly: there is no
compiled program per shape, and ``output`` returns a tensor on the
network's device without waiting for it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import apply_layer
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration


def _copy_tree(tree, device):
    """A copy of a (nested) dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


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
        # whether each layer's output keeps the time axis a features mask
        # applies to; the mask is dropped after a layer that collapses time
        self._mask_survives = [layer.output_type(it).kind in ("rnn", "cnn1d")
                               for layer, it in zip(self.layers,
                                                    conf.layer_input_types())]
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
        out.params, out.state = ([_copy_tree(p, out.device) for p in tree]
                                 for tree in (self.params, self.state))
        return out

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _forward(self, x: torch.Tensor, mask=None) -> List[torch.Tensor]:
        """Inference forward; returns every layer's activation. The features
        ``mask`` (batch, time) reaches each layer while its input has a time
        axis."""
        acts = []
        for i, layer in enumerate(self.layers):
            if i in self._pre:
                x = self._pre[i].apply(x)
            x, _ = apply_layer(layer, self.params[i], self.state[i], x, train=False,
                               rng=None, mask=mask)
            if not self._mask_survives[i]:
                mask = None
            acts.append(x)
        return acts

    @torch.inference_mode()
    def output(self, x, features_mask=None) -> torch.Tensor:
        """Inference forward pass (reference MultiLayerNetwork.output, with
        the features mask of its 4-argument overload)."""
        if self.params is None:
            self.init()
        fm = (None if features_mask is None else
              torch.as_tensor(features_mask, dtype=torch.float32, device=self.device))
        return self._forward(self._as_input(x), fm)[-1]

    def predict(self, x, features_mask=None) -> np.ndarray:
        """Class indices (reference MultiLayerNetwork.predict)."""
        return self.output(x, features_mask).argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations (reference feedForward)."""
        return self._forward(self._as_input(x))
