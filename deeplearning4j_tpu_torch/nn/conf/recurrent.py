"""Sequence layers the transformer path needs (counterpart of the
``RnnOutputLayer``, ``EmbeddingLayer`` and ``EmbeddingSequenceLayer`` of
``deeplearning4j_tpu/nn/conf/recurrent.py``).

Recurrent activations are (batch, time, size), as in the JAX package. The
embeddings take integer ids and gather rows of ``W`` (vocab, n_out); ids
are cast to ``long`` for the gather, so callers may pass int32, int64 or
integer-valued floats. The LSTM family is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayer, BaseOutputLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.initializers import init_weights


def _table(layer, gen, n_in, device) -> dict:
    params = {"W": init_weights(gen, (n_in, layer.n_out), n_in, layer.n_out,
                                layer.weight_init, layer.dist, device)}
    if getattr(layer, "has_bias", False):
        params["b"] = torch.full((layer.n_out,), float(layer.bias_init), device=device)
    return params


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output (reference nn/conf/layers/RnnOutputLayer.java):
    dense over the feature axis of (batch, time, n_in); ``pre_output`` and
    the activation run over the last axis."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True
    activation: str = "softmax"

    def input_kind(self):
        return "rnn"

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        return _table(self, gen, self.n_in or it.size, device), {}


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(BaseLayer):
    """Index -> vector lookup (reference nn/conf/layers/EmbeddingLayer.java):
    the input is a column of integer ids, (batch,) or (batch, 1)."""

    n_in: Optional[int] = None  # vocab size
    n_out: int = 0
    has_bias: bool = True
    activation: str = "identity"
    #: its input is ids: a network's compute dtype is not applied to it
    takes_ids: ClassVar[bool] = True

    def input_kind(self):
        return "ff"

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, gen, it: InputType, device):
        return _table(self, gen, self.n_in or it.flat_size(), device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        z = params["W"][idx]
        if "b" in params:
            z = z + params["b"]
        return get_activation(self.activation)(z), state


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(BaseLayer):
    """A sequence of ids, (batch, time) or (batch, time, 1), to
    (batch, time, n_out)."""

    n_in: Optional[int] = None  # vocab size
    n_out: int = 0
    #: its input is ids: a network's compute dtype is not applied to it
    takes_ids: ClassVar[bool] = True

    def input_kind(self):
        return "rnn"

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        return _table(self, gen, self.n_in or it.size, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.dim() == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        return params["W"][x.long()], state


__all__ = ["RnnOutputLayer", "EmbeddingLayer", "EmbeddingSequenceLayer"]
