"""Global pooling (counterpart of ``deeplearning4j_tpu/nn/conf/pooling.py``):
pools NHWC over H and W, or (batch, time, size) over time, to a
feed-forward vector. A features mask reaching a time series leaves the
masked steps out of every pooling type, as in the JAX package; NHWC
activations pool every position (the JAX package's layer takes no mask
there either)."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    """pooling_type: max | avg | sum | pnorm (reference PoolingType enum)."""

    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True  # False keeps size-1 pooled dims

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "cnn":
            if self.collapse_dimensions:
                return InputType.feed_forward(it.channels)
            return InputType.convolutional(1, 1, it.channels)
        if it.kind == "rnn":
            if self.collapse_dimensions:
                return InputType.feed_forward(it.size)
            return InputType.recurrent(it.size, 1)
        return it

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.dim() == 4:      # NHWC: pool over H, W
            axes = (1, 2)
            m = None
        elif x.dim() == 3:    # (batch, time, size): pool over time, mask-aware
            axes = (1,)
            m = None if mask is None else mask[..., None].to(x.dtype)  # (b, t, 1)
        else:
            return x, state
        keep = not self.collapse_dimensions
        pt = self.pooling_type.lower()
        if pt == "max":
            if m is not None:
                x = torch.where(m > 0, x, float("-inf"))
            out = torch.amax(x, dim=axes, keepdim=keep)
        elif pt == "sum":
            if m is not None:
                x = x * m
            out = torch.sum(x, dim=axes, keepdim=keep)
        elif pt == "avg":
            if m is not None:
                out = (torch.sum(x * m, dim=axes, keepdim=keep)
                       / torch.clamp_min(torch.sum(m, dim=axes, keepdim=keep), 1.0))
            else:
                out = torch.mean(x, dim=axes, keepdim=keep)
        elif pt == "pnorm":
            p = float(self.pnorm)
            if m is not None:
                x = x * m
            out = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=keep) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
        return out, state
