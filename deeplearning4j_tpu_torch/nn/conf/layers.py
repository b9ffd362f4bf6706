"""Layer configurations + implementations, feed-forward core (counterpart of
``deeplearning4j_tpu/nn/conf/layers.py``).

Each config is a frozen dataclass with the JAX package's field names, so the
configuration JSON is read and written under the same schema. Beside the
config, each layer carries two plain functions on tensors, with the JAX
package's signatures:

- ``init(gen, input_type, device) -> (params, state)``: ``params`` is a dict
  of trainable tensors drawn from an explicit ``torch.Generator``, in the
  JAX package's layouts (``(n_in, n_out)`` dense weights); ``state`` a dict
  of non-trainable buffers (batch-norm running stats);
- ``apply(params, state, x, *, train=False, rng=None, mask=None) -> (out,
  new_state)``: the forward. ``rng`` is a ``torch.Generator`` for dropout;
  ``mask`` a (batch, time) features mask, which the recurrent and attention
  layers read and the others ignore. Gradients come from autograd.

Dropout follows DL4J 0.9: ``dropout`` is the *retain* probability applied
to the layer's input when training (0 disables). The training knobs
``remat``, ``constraints`` and ``weight_noise`` are carried so the JSON
round-trips; a layer that sets one raises ``NotImplementedError`` when it
trains (:func:`apply_layer`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import lossfunctions
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.initializers import Distribution, init_weights
from deeplearning4j_tpu_torch.optimize.updaters import Updater

LAYER_REGISTRY = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_to_dict(conf) -> dict:
    d = {"@class": type(conf).__name__}
    for f in dataclasses.fields(conf):
        v = getattr(conf, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v) and hasattr(v, "to_dict"):
            v = v.to_dict()
        elif isinstance(v, (tuple, list)):
            v = [e.to_dict() if dataclasses.is_dataclass(e)
                 and hasattr(e, "to_dict") else e for e in v]
        d[f.name] = v
    return d


def layer_from_dict(d: dict):
    d = dict(d)
    name = d.pop("@class")
    if name not in LAYER_REGISTRY:
        raise KeyError(
            f"layer type '{name}' is not in the PyTorch port yet "
            f"(ported: {sorted(LAYER_REGISTRY)})")
    cls = LAYER_REGISTRY[name]
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if k == "updater" and isinstance(v, dict):
            v = Updater.from_dict(v)
        elif k == "dist" and isinstance(v, dict):
            v = Distribution.from_dict(v)
        elif _names_layer(v):  # nested layer
            v = layer_from_dict(v)
        elif isinstance(v, list):  # JSON has no tuples
            v = tuple(layer_from_dict(e) if _names_layer(e) else e
                      for e in v)
        # any other dict (constraints, weight noise) stays verbatim
        kwargs[k] = v
    return cls(**kwargs)


def _names_layer(v) -> bool:
    return isinstance(v, dict) and v.get("@class") in LAYER_REGISTRY


def regularization_coefficients(layer):
    """(l1, l2, l1_bias, l2_bias) for a layer; wrapper layers (those with a
    nested ``layer`` field) fall back to the inner layer's coefficients when
    their own are all zero."""
    vals = (getattr(layer, "l1", 0.0) or 0.0, getattr(layer, "l2", 0.0) or 0.0,
            getattr(layer, "l1_bias", 0.0) or 0.0,
            getattr(layer, "l2_bias", 0.0) or 0.0)
    inner = getattr(layer, "layer", None)
    if inner is not None and not any(vals):
        return regularization_coefficients(inner)
    return vals


def resolve_param_path(params: dict, key: str):
    """A possibly nested '/'-separated parameter key (the attention layers'
    ``"q/W"``) resolved in ``params``; None where it is missing."""
    node = params
    for part in key.split("/"):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node


def _bias_keys(layer, params: dict) -> list:
    """Bias parameter paths: a top-level ``"b"``, plus the sibling ``.../b``
    of every nested weight path (``"q/W"`` -> ``"q/b"``)."""
    keys = []
    if resolve_param_path(params, "b") is not None:
        keys.append("b")
    for wk in layer.regularizable():
        if "/" in wk:
            bk = wk.rsplit("/", 1)[0] + "/b"
            if bk not in keys and resolve_param_path(params, bk) is not None:
                keys.append(bk)
    return keys


def regularization_penalty(layer, params: dict):
    """The layer's l1/l2 score term (reference BaseLayer.calcL1/calcL2):
    ``layer.regularizable()`` paths with l1/l2, :func:`_bias_keys` with
    l1_bias/l2_bias; low-precision leaves are summed in float32."""
    l1, l2, l1b, l2b = regularization_coefficients(layer)
    terms = [(w, l1, l2) for w in (resolve_param_path(params, k)
                                    for k in layer.regularizable()) if w is not None]
    if l1b or l2b:
        terms += [(resolve_param_path(params, k), l1b, l2b)
                  for k in _bias_keys(layer, params)]
    total = 0.0
    for w, c1, c2 in terms:
        if w.dtype in (torch.bfloat16, torch.float16):
            w = w.float()
        if c2:
            total = total + 0.5 * c2 * torch.sum(w * w)
        if c1:
            total = total + c1 * torch.sum(torch.abs(w))
    return total


def dropout_input(x, dropout, train: bool, rng: Optional[torch.Generator]):
    """Inverted dropout on a layer's input; ``dropout`` is the retain
    probability. The keep mask is drawn from ``rng`` (a generator on x's
    device). Only the plain retain-probability form is ported; the JAX
    package's IDropout objects are not."""
    if not dropout:  # None / 0.0: disabled
        return x
    if not isinstance(dropout, (int, float)):
        raise NotImplementedError(
            f"dropout {dropout!r}: only a retain probability is ported")
    p = float(dropout)
    if not train or rng is None or p >= 1.0 or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) < p
    return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                device=x.device)).to(x.dtype)


def refuse_training_knobs(layer):
    """Rematerialization, constraints and weight noise are not ported: a
    layer that sets one raises when it trains."""
    for knob in ("remat", "constraints", "weight_noise"):
        if getattr(layer, knob, None):
            raise NotImplementedError(
                f"{type(layer).__name__} '{layer.name}' sets {knob}=; "
                f"training with {knob} is not in the PyTorch port yet")


def apply_layer(layer, params, state, x, *, train, rng, mask=None, extra=None):
    """The networks' single entry into ``layer.apply`` (recurrent layers
    with carries go through ``apply_seq``). ``mask`` is the (batch, time)
    features mask the recurrent and attention layers take; ``extra``
    carries additional inputs (the fused residual-add operand)."""
    if train:
        refuse_training_knobs(layer)
    return layer.apply(params, state, x, train=train, rng=rng, mask=mask,
                       **(extra or {}))


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base of all layer configs (reference nn/conf/layers/Layer.java)."""

    name: Optional[str] = None
    dropout: float = 0.0
    # training-time rematerialization knob of the JAX package; carried so
    # the JSON round-trips, refused in training (apply_layer)
    remat: Optional[str] = None

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, gen: torch.Generator, input_type: InputType, device):
        return {}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        raise NotImplementedError

    # which param keys get l1/l2 (weights only)
    def regularizable(self) -> Tuple[str, ...]:
        return ()

    def is_output_layer(self) -> bool:
        return False

    def is_recurrent(self) -> bool:
        return False

    def input_kind(self) -> str:
        """Preferred input family for automatic preprocessor insertion:
        'ff' | 'cnn' | 'rnn' | 'any'."""
        return "any"

    def with_n_in(self, n_in: int):
        """Fill in n_in during config wiring."""
        if hasattr(self, "n_in") and getattr(self, "n_in") in (None, 0):
            return dataclasses.replace(self, n_in=n_in)
        return self

    def to_dict(self):
        return layer_to_dict(self)


@dataclasses.dataclass(frozen=True)
class BaseLayer(Layer):
    """Layers with weights (reference nn/conf/layers/BaseLayer.java): carry
    activation, weight init, regularization and per-layer updater override.
    ``constraints`` and ``weight_noise`` are kept verbatim as the JSON
    values the JAX package writes."""

    activation: str = "identity"
    weight_init: str = "xavier"
    dist: Optional[Distribution] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    updater: Optional[Updater] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    constraints: Optional[tuple] = None
    weight_noise: Optional[object] = None

    def regularizable(self):
        return ("W",)


def _dense_init(layer, gen, input_type, device) -> dict:
    n_in = layer.n_in or input_type.flat_size()
    params = {"W": init_weights(gen, (n_in, layer.n_out), n_in, layer.n_out,
                                layer.weight_init, layer.dist, device)}
    if layer.has_bias:
        params["b"] = torch.full((layer.n_out,), float(layer.bias_init),
                                 device=device)
    return params


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(BaseLayer):
    """Fully connected layer: y = act(x @ W + b), W is (n_in, n_out)."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    def input_kind(self):
        return "ff"

    def output_type(self, input_type):
        if input_type.kind == "rnn":  # dense broadcasts over time natively
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, device):
        return _dense_init(self, gen, input_type, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return get_activation(self.activation)(z), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """Pure activation (reference nn/conf/layers/ActivationLayer.java).
    ``activation_param`` feeds parameterized activations (LeakyReLU alpha,
    ELU alpha, ThresholdedReLU theta)."""

    activation: str = "relu"
    activation_param: Optional[float] = None

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        fn = get_activation(self.activation)
        if self.activation_param is not None:
            return fn(x, self.activation_param), state
        return fn(x), state


@dataclasses.dataclass(frozen=True)
class BaseOutputLayer(BaseLayer):
    """Loss-bearing layers. ``pre_output`` returns the pre-activation z used
    by the numerically stable fused loss, ``output_activations`` the
    network's predictions, ``compute_score`` the mask-aware mean loss."""

    loss: str = "mcxent"
    loss_weights: Optional[Tuple[float, ...]] = None

    def is_output_layer(self):
        return True

    def pre_output(self, params, x):
        z = x @ params["W"]
        if "b" in params:
            z = z + params["b"]
        return z

    def output_activations(self, preout):
        return get_activation(self.activation)(preout)

    def compute_score(self, labels, preout, mask=None):
        return lossfunctions.score(self.loss, labels, preout, self.activation,
                                   mask, self.loss_weights)

    def compute_score_array(self, labels, preout, mask=None):
        return lossfunctions.score_array(self.loss, labels, preout,
                                         self.activation, mask,
                                         self.loss_weights)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        return self.output_activations(self.pre_output(params, x)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(BaseOutputLayer):
    """Dense + loss (reference nn/conf/layers/OutputLayer.java)."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True
    activation: str = "softmax"

    def input_kind(self):
        return "ff"

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, device):
        return _dense_init(self, gen, input_type, device), {}
