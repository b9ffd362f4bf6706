"""Input preprocessors — shape adapters between layer families (counterpart
of ``deeplearning4j_tpu/nn/conf/preprocessors.py``): CNN ↔ feed-forward and
the four RNN adapters.

``apply(x, mask=None) -> (x, mask)``: the (batch, time) features mask is
reshaped with the activations (flattened to (batch*time,) where time
folds into the batch, back to (batch, time) where it unfolds).

CNN activations are NHWC, so ``CnnToFeedForwardPreProcessor`` flattens in
``(h, w, c)`` order, the order a dense layer after a conv stack was trained
in. Flattening an NCHW tensor instead would silently permute that layer's
input weights. RNN activations are (batch, time, size).
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

_PRE_REGISTRY = {}


def register_preprocessor(cls):
    _PRE_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_to_dict(p):
    d = dataclasses.asdict(p)
    d["@class"] = type(p).__name__
    return d


def preprocessor_from_dict(d):
    d = dict(d)
    name = d.pop("@class")
    if name not in _PRE_REGISTRY:
        raise KeyError(f"preprocessor '{name}' is not in the PyTorch port yet")
    return _PRE_REGISTRY[name](**d)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class CnnToFeedForwardPreProcessor:
    """NHWC -> flat, in (h, w, c) order."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.flat_size())

    def apply(self, x, mask=None):
        return x.reshape(x.shape[0], -1), mask


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class FeedForwardToCnnPreProcessor:
    """flat -> NHWC."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, x, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels), mask


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class RnnToFeedForwardPreProcessor:
    """(batch, time, size) -> (batch*time, size); the mask flattens with it."""

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.size)

    def apply(self, x, mask=None):
        b, t, s = x.shape
        return x.reshape(b * t, s), None if mask is None else mask.reshape(b * t)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnnPreProcessor:
    """(batch*time, size) -> (batch, time, size) at ``timeseries_length``."""

    timeseries_length: int = 0

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.flat_size(), self.timeseries_length or None)

    def apply(self, x, mask=None):
        t = self.timeseries_length
        return (x.reshape(-1, t, x.shape[-1]),
                None if mask is None else mask.reshape(-1, t))


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class RnnToCnnPreProcessor:
    """(batch, time, h*w*c) -> (batch*time, h, w, c)."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, x, mask=None):
        b, t, _ = x.shape
        return (x.reshape(b * t, self.height, self.width, self.channels),
                None if mask is None else mask.reshape(b * t))


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class CnnToRnnPreProcessor:
    """(batch*time, h, w, c) -> (batch, time, h*w*c) at ``timeseries_length``."""

    timeseries_length: int = 0

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.flat_size(), self.timeseries_length or None)

    def apply(self, x, mask=None):
        t = self.timeseries_length
        flat = x.reshape(x.shape[0], -1)
        return (flat.reshape(-1, t, flat.shape[-1]),
                None if mask is None else mask.reshape(-1, t))


def infer_preprocessor(cur: InputType, layer):
    """Automatic adapter insertion: CNN -> dense flattens, flat CNN input ->
    conv unflattens. A dense layer takes (batch, time, size) as it is (x @ W
    broadcasts over time), and an RNN layer after a dense one needs none."""
    want = layer.input_kind()
    if want == "any" or cur is None:
        return None
    if want == "ff" and cur.kind == "cnn":
        return CnnToFeedForwardPreProcessor(cur.height, cur.width, cur.channels)
    if want == "cnn" and cur.kind == "cnn_flat":
        return FeedForwardToCnnPreProcessor(cur.height, cur.width, cur.channels)
    if want == "cnn" and cur.kind == "ff":
        raise ValueError(
            "Cannot infer CNN shape from plain feed-forward input; use "
            "InputType.convolutional_flat or an explicit FeedForwardToCnnPreProcessor")
    return None
