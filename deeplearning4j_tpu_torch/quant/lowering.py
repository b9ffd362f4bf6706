"""Quantized lowering of dense/conv layers for serving graphs (counterpart of
``deeplearning4j_tpu/quant/lowering.py``).

The scheme is the JAX package's, step for step, so both packages compute
the same integers:

- weights: per-output-channel symmetric int8 (``Wq (n_in, n_out)``/HWIO), or
  packed int4 (``Wq (n_out, ceil(fan_in/2))``, fan-in flattened in
  ``(kh, kw, c_in)`` order), quantized on the host with numpy;
- activations: ``clip(round(x * float32(1 / s_in)), -127, 127)`` — a
  multiply by the float32 of the Python-double reciprocal, not a divide;
  ``torch.round`` and ``jnp.round`` both round half to even;
- products accumulate in int32, then ONE requantize per layer:
  ``acc * (float32(s_in) * s_w)``, the scale product first, then the
  accumulator, then ``+ b`` and the activation in float32.

Where the products run:

- int4 dense/output layers: the ``int4_dot`` kernel
  (``perf/kernels/int4_dot.py``). A CUDA tensor always goes to the kernel;
  activations with more than two dimensions are reshaped to ``(rows, d)``
  and still go to it.
- int4/int8 convolutions and int8 dense layers: integer-valued float64
  tensors through ``F.conv2d``/``@``, cast to int32. Exact: every partial
  sum is an integer far below 2**53. PyTorch has no int8 convolution on
  CUDA, and a float32 cuDNN convolution is exact only if no Winograd/FFT
  algorithm is chosen and TF32 is off, which cannot be guaranteed. These
  are library calls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    ConvolutionLayer, _conv_out, _pair, _same_pads, conv2d_nhwc)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer, DenseLayer, Layer, OutputLayer, register_layer)
from deeplearning4j_tpu_torch.perf.kernels import int4_dot
from deeplearning4j_tpu_torch.quant.observers import QMAX
from deeplearning4j_tpu_torch.quant.pack import (packed_width, quantize_int4,
                                                 unpack_nibbles)

__all__ = [
    "QuantizedDenseLayer", "QuantizedConvolutionLayer",
    "QuantizedConvolution1DLayer", "QuantizedOutputLayer",
    "quantize", "quantizable_kind", "quantize_weights",
    "quantize_weights_int4", "is_quantized", "quantized_layers",
]


# ------------------------------------------------------------- primitives
def quantize_activation(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """f32 → int8 on the symmetric grid with a static calibrated scale."""
    inv = float(np.float32(1.0 / act_scale))
    return torch.clamp(torch.round(x * inv), -QMAX, QMAX).to(torch.int8)


def quantize_weights(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 weights (host, numpy). Channel =
    the LAST axis. Returns ``(Wq int8, scale f32[n_out])``."""
    w = np.asarray(w)
    amax = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0)
    scale = np.maximum(amax, np.float32(1e-12)) / np.float32(QMAX)
    scale = np.ascontiguousarray(scale, dtype=w.dtype)
    q = np.clip(np.rint(w / scale), -QMAX, QMAX).astype(np.int8)
    return q, scale


def quantize_weights_int4(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int4 weights, packed: rows of ``Wq`` are
    OUTPUT CHANNELS, ``(n_out, ceil(fan_in/2))`` int8. Returns
    ``(Wq packed, scale f32[n_out])``."""
    w = np.asarray(w)
    w2d = np.ascontiguousarray(w.reshape(-1, w.shape[-1]).T)  # (n_out, fan)
    packed, scales, _ = quantize_int4(w2d)
    return packed, scales.astype(np.float32)


def _requantize(acc_i32: torch.Tensor, act_scale: float, w_scale: torch.Tensor):
    """int32 accumulator → f32: ``acc * (s_in * s_w[c])``."""
    s = float(np.float32(act_scale)) * w_scale
    return acc_i32.to(torch.float32) * s  # lint: disable=DLT010 (the single per-layer requantize)


def _dense_int4_acc(xq: torch.Tensor, wq_packed: torch.Tensor, n_in: int):
    """int8 activations × packed int4 weights → int32 through ``int4_dot``,
    for any number of leading dimensions."""
    lead = xq.shape[:-1]
    acc = int4_dot.int4_matmul(xq.reshape(-1, n_in).contiguous(), wq_packed, n_in)
    return acc.reshape(lead + (wq_packed.shape[0],))


def _int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (…, n_in) × int8 (n_in, n_out) → int32, exact through float64."""
    return (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)


def _conv_weight_int8(wq_packed, spatial, c_in: int, n_out: int):
    """Unpack packed int4 conv weights back to the conv's native layout
    (HWIO / WIO): rows are output channels, fan-in keeps the
    (spatial..., c_in) order the lowering flattened."""
    fan = int(np.prod(spatial)) * c_in
    w8 = unpack_nibbles(wq_packed, fan)
    w8 = w8.reshape((n_out,) + tuple(spatial) + (c_in,))
    return torch.movedim(w8, 0, -1)                      # (*spatial, ci, co)


def _finish(layer, params, acc):
    z = _requantize(acc, layer.act_scale, params["w_scale"])
    if layer.has_bias:
        z = z + params["b"]
    return z


def _qparams(wq_shape, n_out, has_bias, device):
    params = {"Wq": torch.zeros(wq_shape, dtype=torch.int8, device=device),
              "w_scale": torch.ones((n_out,), dtype=torch.float32, device=device)}
    if has_bias:
        params["b"] = torch.zeros((n_out,), dtype=torch.float32, device=device)
    return params


# ---------------------------------------------------------------- layers
@register_layer
@dataclasses.dataclass(frozen=True)
class QuantizedDenseLayer(Layer):
    """Quantized DenseLayer: y = act(deq(xq @int32 Wq) + b)."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True
    activation: str = "identity"
    act_scale: float = 1.0
    weight_bits: int = 8

    def input_kind(self):
        return "ff"

    def output_type(self, input_type):
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, device):
        n_in = self.n_in or input_type.flat_size()
        wq_shape = ((self.n_out, packed_width(n_in))
                    if self.weight_bits == 4 else (n_in, self.n_out))
        return _qparams(wq_shape, self.n_out, self.has_bias, device), {}

    def pre_output(self, params, x):
        xq = quantize_activation(x, self.act_scale)
        if self.weight_bits == 4:
            acc = _dense_int4_acc(xq, params["Wq"], self.n_in)
        else:
            acc = _int_matmul(xq, params["Wq"])
        return _finish(self, params, acc)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return get_activation(self.activation)(self.pre_output(params, x)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class QuantizedOutputLayer(BaseOutputLayer):
    """Quantized OutputLayer: the logits product runs int8×int4/int8 →
    int32; softmax stays f32."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True
    activation: str = "softmax"
    act_scale: float = 1.0
    weight_bits: int = 8

    def input_kind(self):
        return "ff"

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    init = QuantizedDenseLayer.init
    pre_output = QuantizedDenseLayer.pre_output


@register_layer
@dataclasses.dataclass(frozen=True)
class QuantizedConvolutionLayer(Layer):
    """Quantized ConvolutionLayer (NHWC / HWIO, exact int32 accumulate).
    Symmetric quantization keeps SAME-padding zeros exact."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = True
    activation: str = "identity"
    act_scale: float = 1.0
    weight_bits: int = 8

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        return ConvolutionLayer.output_type(self, it)

    def with_n_in(self, n_in):
        return self  # channels come from the source conv at quantize time

    def init(self, gen, it: InputType, device):
        kh, kw = _pair(self.kernel_size)
        c_in = self.n_in or it.channels
        wq_shape = ((self.n_out, packed_width(kh * kw * c_in))
                    if self.weight_bits == 4 else (kh, kw, c_in, self.n_out))
        return _qparams(wq_shape, self.n_out, self.has_bias, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        xq = quantize_activation(x, self.act_scale)
        if self.weight_bits == 4:
            w = _conv_weight_int8(params["Wq"], _pair(self.kernel_size),
                                  self.n_in, self.n_out)
        else:
            w = params["Wq"]
        acc = conv2d_nhwc(xq.to(torch.float64), w.to(torch.float64),  # lint: disable=DLT010 (CUDA has no integer convolution: float64 holds every int8 partial sum exactly, cast to int32 below)
                          self.stride, self.padding, self.convolution_mode,
                          self.dilation).to(torch.int32)
        return get_activation(self.activation)(_finish(self, params, acc)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class QuantizedConvolution1DLayer(Layer):
    """Quantized Convolution1DLayer (NWC / WIO, exact int32 accumulate).
    Read from the JAX package's quantized configurations; the port has no
    float Convolution1DLayer to lower from yet."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "truncate"
    dilation: int = 1
    has_bias: bool = True
    activation: str = "identity"
    act_scale: float = 1.0
    weight_bits: int = 8

    def input_kind(self):
        return "rnn"

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length
        if t is not None:
            t = _conv_out(t, self.kernel_size, self.stride, self.padding,
                          self.convolution_mode, self.dilation)
        return InputType.recurrent(self.n_out, t)

    def init(self, gen, it: InputType, device):
        c_in = self.n_in or it.size
        wq_shape = ((self.n_out, packed_width(self.kernel_size * c_in))
                    if self.weight_bits == 4
                    else (self.kernel_size, c_in, self.n_out))
        return _qparams(wq_shape, self.n_out, self.has_bias, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        xq = quantize_activation(x, self.act_scale)
        if self.weight_bits == 4:
            w = _conv_weight_int8(params["Wq"], (self.kernel_size,),
                                  self.n_in, self.n_out)
        else:
            w = params["Wq"]
        xc = xq.to(torch.float64).permute(0, 2, 1)  # NCW  # lint: disable=DLT010 (exact integer conv in float64, as above)
        if self.convolution_mode == "same":
            lo, hi = _same_pads(xc.shape[2], self.kernel_size, self.stride,
                                self.dilation)
        else:
            lo = hi = self.padding
        xc = F.pad(xc, (lo, hi))
        acc = F.conv1d(xc, w.to(torch.float64).permute(2, 1, 0),  # lint: disable=DLT010 (exact integer conv in float64)
                       stride=self.stride, dilation=self.dilation)
        acc = acc.permute(0, 2, 1).to(torch.int32)
        return get_activation(self.activation)(_finish(self, params, acc)), state


_QUANTIZED_TYPES = (QuantizedDenseLayer, QuantizedConvolutionLayer,
                    QuantizedConvolution1DLayer, QuantizedOutputLayer)


# ------------------------------------------------------------- rewriters
def quantizable_kind(layer) -> Optional[str]:
    """Which lowering (if any) applies to a layer. EXACT type match."""
    return {DenseLayer: "dense", ConvolutionLayer: "conv",
            OutputLayer: "output"}.get(type(layer))


def _fold_bn(net, fold: bool):
    """``fold=True`` targets the BN-folded serving graph
    (``perf.fusion.fold_bn``), as the JAX package's ``quantize`` does."""
    if not fold:
        return net
    from deeplearning4j_tpu_torch.perf.fusion import fold_bn
    return fold_bn(net)


def _lower_layer(layer, kind: str, params: dict, act_scale: float,
                 weight_bits: int, device):
    """One layer's integer lowering: quantized config + quantized params."""
    w = params["W"].detach().cpu().numpy()
    wq, ws = (quantize_weights_int4(w) if weight_bits == 4
              else quantize_weights(w))
    has_bias = "b" in params
    common = dict(name=layer.name, has_bias=has_bias,
                  activation=layer.activation, act_scale=float(act_scale),
                  weight_bits=int(weight_bits))
    if kind == "dense":
        ql = QuantizedDenseLayer(n_in=w.shape[0], n_out=w.shape[1], **common)
    elif kind == "conv":
        ql = QuantizedConvolutionLayer(
            n_in=w.shape[2], n_out=w.shape[3],
            kernel_size=layer.kernel_size, stride=layer.stride,
            padding=layer.padding, convolution_mode=layer.convolution_mode,
            dilation=layer.dilation, **common)
    elif kind == "output":
        ql = QuantizedOutputLayer(n_in=w.shape[0], n_out=w.shape[1],
                                  loss=layer.loss,
                                  loss_weights=layer.loss_weights, **common)
    else:
        raise KeyError(kind)
    qp = {"Wq": torch.from_numpy(wq).to(device),
          "w_scale": torch.from_numpy(ws).to(device)}
    if has_bias:
        qp["b"] = params["b"].detach().clone()
    return ql, qp


def quantize(net, calibration, fold: bool = True, weight_bits: int = 8):
    """Lower a MultiLayerNetwork to its integer serving graph using a
    calibration record. Returns a NEW network on the same device;
    ``weight_bits=4`` packs per-output-channel int4 weights (two codes per
    byte), served through the ``int4_dot`` kernel."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.quant.calibrate import (CalibrationRecord,
                                                          signature_of)

    if not isinstance(calibration, CalibrationRecord):
        raise TypeError(
            "quantize() needs a CalibrationRecord (run quant.calibrate "
            f"over a representative batch stream); got "
            f"{type(calibration).__name__}")
    if int(weight_bits) not in (4, 8):
        raise ValueError(f"weight_bits must be 4 or 8; got {weight_bits}")
    if not isinstance(net, MultiLayerNetwork):
        raise TypeError(f"quantize() expects a MultiLayerNetwork, got "
                        f"{type(net).__name__}")
    if net.params is None:
        net.init()
    net = _fold_bn(net, fold)
    sig = signature_of(net)
    if sig != calibration.signature:
        raise ValueError(
            "calibration record does not match this network's quantizable "
            f"layers (record: {list(calibration.signature)}; network: "
            f"{list(sig)}) — calibrate the same graph you quantize")
    new_layers, new_params, new_state = [], [], []
    for i, l in enumerate(net.conf.layers):
        kind = quantizable_kind(l)
        key = f"layer{i}"
        if kind is None or key not in calibration.ranges:
            new_layers.append(l)
            new_params.append({k: v.detach().clone()
                               for k, v in net.params[i].items()})
            new_state.append({k: v.detach().clone()
                              for k, v in net.state[i].items()})
            continue
        ql, qp = _lower_layer(net.layers[i], kind, net.params[i],
                              calibration.scale(key), int(weight_bits),
                              net.device)
        new_layers.append(ql)
        new_params.append(qp)
        new_state.append({})
    conf = dataclasses.replace(net.conf, layers=tuple(new_layers),
                               dtype="float32")
    out = MultiLayerNetwork(conf, net.device)
    out.params = new_params
    out.state = new_state
    out._quant_calibration = calibration
    return out


# -------------------------------------------------------------- inspection
def quantized_layers(net):
    """(slot_key, layer) for every Quantized* layer of a network (none in a
    ComputationGraph: the lowering rewrites layer stacks)."""
    return [(f"layer{i}", l) for i, l in enumerate(getattr(net, "layers", ()))
            if isinstance(l, _QUANTIZED_TYPES)]


def is_quantized(net) -> bool:
    return bool(quantized_layers(net))



def input_quant_scale(net) -> Optional[float]:
    """The activation scale of the quantized layer that consumes the
    NETWORK INPUT — the grid an int8 wire payload is encoded on (serving
    accepts ``dtype: "int8"`` tensors only when this is defined). None when
    the first layer is not quantized."""
    layers = getattr(net, "layers", None)
    if layers and isinstance(layers[0], _QUANTIZED_TYPES):
        return float(layers[0].act_scale)
    return None
