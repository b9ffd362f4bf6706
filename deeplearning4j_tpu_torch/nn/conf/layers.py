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
to the layer's input when training (0 disables), or an ``IDropout`` object
(``nn/conf/regularization.py``). The training knobs every layer carries:
``constraints`` map parameters after each updater step
(:func:`apply_constraints`), ``weight_noise`` transforms weights in the
training forward (:func:`noisy_params`), and ``remat`` recomputes the
layer's forward in the backward (:func:`apply_layer`, through
``perf/fusion.py``'s ``remat_apply``).
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
    """Dropout on a layer's input: ``dropout`` is a retain probability or
    an ``IDropout`` object; its draws come from ``rng`` (a generator on x's
    device)."""
    if not dropout:  # None / 0.0: disabled
        return x
    if not hasattr(dropout, "apply"):
        from deeplearning4j_tpu_torch.nn.conf.regularization import Dropout
        dropout = Dropout(float(dropout))
    return dropout.apply(x, rng, train)


def reg_object(layer, attr: str):
    """``constraints`` / ``weight_noise`` of a layer, or of the layer a
    wrapper config wraps when the wrapper sets none."""
    v = getattr(layer, attr, None)
    if v is None:
        inner = getattr(layer, "layer", None)
        if inner is not None:
            return reg_object(inner, attr)
    return v


def _constraint_keys(layer, params: dict, c) -> list:
    keys = []
    if getattr(c, "apply_to_weights", True):
        keys.extend(k for k in layer.regularizable()
                    if resolve_param_path(params, k) is not None)
    if getattr(c, "apply_to_biases", False):
        keys.extend(_bias_keys(layer, params))
    return keys


def apply_constraints(layer, params: dict) -> dict:
    """The layer's parameter constraints, applied in place after an update
    (reference BaseConstraint.applyConstraint), in the order listed."""
    cons = reg_object(layer, "constraints")
    if not cons:
        return params
    with torch.no_grad():
        for c in cons:
            for key in _constraint_keys(layer, params, c):
                w = resolve_param_path(params, key)
                w.copy_(c.apply(w))
    return params


def weight_noise_keys(layer, params: dict) -> list:
    """The parameter paths the layer's weight noise transforms, in the
    order :func:`noisy_params` draws for them."""
    wn = reg_object(layer, "weight_noise")
    keys = [k for k in layer.regularizable() if resolve_param_path(params, k) is not None]
    if wn.apply_to_bias:
        keys.extend(_bias_keys(layer, params))
    return keys


def noisy_params(layer, params: dict, rng: Optional[torch.Generator], train: bool,
                 draws: Optional[dict] = None) -> dict:
    """The layer's parameters with its weight noise applied, for a training
    forward (reference BaseLayer.getParamWithNoise). The noise is drawn
    from ``rng``, one draw per path of :func:`weight_noise_keys` in order,
    unless ``draws`` (path -> draw) gives them. Without weight noise, or
    outside training, ``params`` itself."""
    wn = reg_object(layer, "weight_noise")
    if wn is None or not train or (rng is None and draws is None):
        return params
    out = dict(params)
    for key in weight_noise_keys(layer, params):
        w = resolve_param_path(params, key)
        r = draws[key] if draws is not None else wn.draw(w.shape, rng, w.device, w.dtype)
        noisy = wn.apply_drawn(w, r)
        if "/" in key:  # nested (wrapper layers): rebuild the nested dicts
            top, rest = key.split("/", 1)
            out[top] = dict(out[top])
            out[top][rest] = noisy
        else:
            out[key] = noisy
    return out


def apply_layer(layer, params, state, x, *, train, rng, mask=None, extra=None):
    """The networks' single entry into ``layer.apply`` (recurrent layers
    with carries go through ``apply_seq``). ``mask`` is the (batch, time)
    features mask the recurrent and attention layers take; ``extra``
    carries additional inputs (the fused residual-add operand). A layer
    whose ``remat=`` knob is set runs under ``perf.fusion.remat_apply`` when
    autograd records."""
    if getattr(layer, "remat", None) and train and torch.is_grad_enabled():
        from deeplearning4j_tpu_torch.perf.fusion import remat_apply
        return remat_apply(layer, params, state, x, rng=rng, mask=mask, extra=extra)
    return layer.apply(params, state, x, train=train, rng=rng, mask=mask,
                       **(extra or {}))


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base of all layer configs (reference nn/conf/layers/Layer.java)."""

    name: Optional[str] = None
    dropout: float = 0.0
    # recompute this layer's forward in the backward (perf/fusion.py
    # REMAT_POLICIES; apply_layer)
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
    activation, weight init, regularization, per-layer updater override,
    post-update ``constraints`` (a tuple of ``BaseConstraint``) and
    training-forward ``weight_noise`` (an ``IWeightNoise``)."""

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


@register_layer
@dataclasses.dataclass(frozen=True)
class PReLULayer(BaseLayer):
    """Parametric ReLU with a learnt negative slope ``alpha`` (reference
    PReLULayer, Keras PReLU). ``shared_axes`` lists 1-based input axes that
    share one alpha (``[1, 2]`` gives one alpha a channel on NHWC)."""

    shared_axes: Optional[Tuple[int, ...]] = None

    def _alpha_shape(self, input_type):
        if input_type.kind == "cnn":
            shape = [input_type.height, input_type.width, input_type.channels]
        elif input_type.kind in ("rnn", "cnn1d"):
            shape = [input_type.timeseries_length or 1, input_type.size]
        else:
            shape = [input_type.flat_size()]
        for ax in self.shared_axes or ():
            shape[ax - 1] = 1
        return tuple(shape)

    def init(self, gen, input_type, device):
        return {"alpha": torch.zeros(self._alpha_shape(input_type), device=device)}, {}

    def regularizable(self):
        return ()

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return torch.where(x >= 0, x, params["alpha"] * x), state


@register_layer
@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Standalone dropout (reference DropoutLayer); ``dropout`` is the
    retain probability or an ``IDropout``."""

    dropout: float = 0.5

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return dropout_input(x, self.dropout, train, rng), state


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
        """The pre-activation; a dict of tensors for a layer whose score
        needs more than it (CenterLoss: features and centers)."""
        z = x @ params["W"]
        if "b" in params:
            z = z + params["b"]
        return z

    def output_activations(self, preout):
        """The network's predictions from ``pre_output``'s result."""
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


@register_layer
@dataclasses.dataclass(frozen=True)
class CenterLossOutputLayer(OutputLayer):
    """Softmax output plus center loss (reference CenterLossOutputLayer):
    loss = interclass(labels, softmax) + lamda/2 * mean ||f - c_y||^2, f the
    layer's input (the embedding), c_y its class's center (``cL``, one row
    a class, zeros at init).

    The centers follow the reference's rule, not the loss gradient: each
    moves toward its class's features at rate ``alpha``, normalised by the
    class's count + 1. That direction is the gradient of a value-neutral
    pseudo-term (its value subtracted again), so any updater trains the
    other parameters while the centers keep the reference's dynamics.
    ``gradient_check=True`` gives the centers the true loss gradient."""

    alpha: float = 0.05
    lamda: float = 2e-4   # "lambda" is a Python keyword; the JSON key is "lamda"
    gradient_check: bool = False

    def init(self, gen, input_type, device):
        params, state = super().init(gen, input_type, device)
        n_in = self.n_in or input_type.flat_size()
        params["cL"] = torch.zeros((self.n_out, n_in), device=device)
        return params, state

    def pre_output(self, params, x):
        z = x @ params["W"]
        if "b" in params:
            z = z + params["b"]
        return {"z": z, "f": x, "cL": params["cL"]}

    def output_activations(self, preout):
        return get_activation(self.activation)(preout["z"])

    def compute_score(self, labels, preout, mask=None):
        inter = lossfunctions.score(self.loss, labels, preout["z"], self.activation,
                                    mask, self.loss_weights)
        f, centers = preout["f"], preout["cL"]
        if self.gradient_check:
            diff = f - labels @ centers
            return inter + 0.5 * self.lamda * torch.mean(torch.sum(diff * diff, -1))
        diff = f - labels @ centers.detach()
        intra = 0.5 * self.lamda * torch.mean(torch.sum(diff * diff, -1))
        counts = torch.sum(labels, 0)
        w_per_ex = labels @ (1.0 / (counts + 1.0))
        cdiff = labels @ centers - f.detach()
        pseudo = 0.5 * self.alpha * torch.sum(w_per_ex[:, None] * cdiff * cdiff)
        pseudo = pseudo - pseudo.detach()  # gradient only, no value
        return inter + intra + pseudo

    def compute_score_array(self, labels, preout, mask=None):
        inter = lossfunctions.score_array(self.loss, labels, preout["z"], self.activation,
                                          mask, self.loss_weights)
        intra = 0.5 * self.lamda * torch.sum((preout["f"] - labels @ preout["cL"]) ** 2, -1)
        return inter + intra


@register_layer
@dataclasses.dataclass(frozen=True)
class LossLayer(BaseOutputLayer):
    """A loss without weights (reference LossLayer)."""

    activation: str = "identity"

    def regularizable(self):
        return ()

    def pre_output(self, params, x):
        return x

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return get_activation(self.activation)(x), state
