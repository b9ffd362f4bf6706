"""Convolution, pooling, padding and cropping layers, and the fused
conv→BN→activation blocks (counterpart of
``deeplearning4j_tpu/nn/conf/convolutional.py``).

Public layouts are the JAX package's: NHWC activations and HWIO kernels;
(batch, time, channels) sequences and WIO kernels for the 1-D layers; a
separable convolution's depthwise kernel is (kh, kw, 1, C * multiplier),
output channel ``c * multiplier + m`` reading input channel c (XLA's
``feature_group_count`` order, which is ``F.conv2d(groups=C)``'s too), and
its pointwise kernel (1, 1, C * multiplier, n_out).
Inside, a layer views its NHWC input as a ``channels_last`` NCHW tensor
(a permute, no copy), moves the kernel to OIHW and calls ``F.conv2d``; the
result is permuted back to NHWC.

Convolution modes follow the JAX package: ``truncate`` is VALID with the
layer's symmetric ``padding``; ``same`` is XLA's ``"SAME"``, which pads
``lo = total // 2`` and ``hi = total - lo``. That split is computed here and
applied with ``F.pad``: torch's ``padding="same"`` refuses stride > 1 and
splits differently. SAME max pooling pads with -inf, as XLA's
``reduce_window`` does with its init value; average pooling pads with 0 and
divides by the full window, padding included.

Float32 convolutions on a card run in full float32: ``device.resolve_device``
turns cuDNN's TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayer, Layer, dropout_input,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.conf.normalization import running_update, scale_shift
from deeplearning4j_tpu_torch.nn.initializers import init_weights
from deeplearning4j_tpu_torch.perf.compile_watch import bump_active
from deeplearning4j_tpu_torch.perf.kernels import bn_act


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_out(size, k, s, pad, mode, dilation=1):
    eff_k = (k - 1) * dilation + 1  # effective kernel under dilation
    if mode == "same":
        return -(-size // s)
    out = (size + 2 * pad - eff_k) // s + 1
    if out <= 0:
        raise ValueError(
            f"Invalid convolution/pooling geometry: input size {size}, kernel {k} "
            f"(effective {eff_k}), stride {s}, padding {pad} gives non-positive "
            f"output size {out}. Use convolution_mode='same' or adjust kernel/padding.")
    return out


def _same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA's SAME split for one spatial dim: (lo, hi), lo = total // 2."""
    eff_k = (k - 1) * dilation + 1
    out = -(-size // s)
    total = max((out - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def _padding_cfg(mode: str, padding, x_nchw, kernel, stride, dilation=(1, 1)):
    """((top, bottom), (left, right)) for the given convolution mode."""
    if mode == "same":
        return tuple(_same_pads(x_nchw.shape[2 + i], kernel[i], stride[i],
                                dilation[i]) for i in range(2))
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


def _pad_nchw(x, pads, value=0.0):
    (t, b), (l, r) = pads
    if t or b or l or r:
        return F.pad(x, (l, r, t, b), value=value)
    return x


def conv2d_nhwc(x, w_hwio, stride, padding, mode, dilation=(1, 1)):
    """NHWC input × HWIO kernel → NHWC output, the one 2-D convolution of the
    port. Runs in the dtype of its operands (float32 or bfloat16, or float64
    for the exact integer convolution of the int4/int8 layers). The result
    is a permuted view: contiguous in NHWC only when cuDNN wrote
    channels_last."""
    xc = x.permute(0, 3, 1, 2)                     # channels_last NCHW view
    k, s, dl = _pair(w_hwio.shape[:2]), _pair(stride), _pair(dilation)
    xc = _pad_nchw(xc, _padding_cfg(mode, padding, xc, k, s, dl))
    w = w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    z = F.conv2d(xc, w, stride=s, dilation=dl)
    return z.permute(0, 2, 3, 1)


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(BaseLayer):
    """2-D convolution. NHWC in, HWIO kernel, NHWC out."""

    n_in: Optional[int] = None  # input channels (inferred)
    n_out: int = 0              # output channels
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"  # truncate|same
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = True
    activation: str = "identity"

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        return _conv_shape(self, it, self.dilation)

    def with_n_in(self, n_in):
        # n_in is channels: set from the input type's channel count in init
        return self

    def init(self, gen, it: InputType, device):
        kh, kw = _pair(self.kernel_size)
        c_in = self.n_in or it.channels
        params = {"W": init_weights(gen, (kh, kw, c_in, self.n_out),
                                    c_in * kh * kw, self.n_out * kh * kw,
                                    self.weight_init, self.dist, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     device=device)
        return params, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        z = conv2d_nhwc(x, params["W"], self.stride, self.padding,
                        self.convolution_mode, self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return get_activation(self.activation)(z), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    """Spatial pooling over NHWC. Modes: max | avg | pnorm."""

    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pooling_type: str = "max"  # max|avg|pnorm
    pnorm: int = 2

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        h = _conv_out(it.height, kh, sh, ph, self.convolution_mode)
        w = _conv_out(it.width, kw, sw, pw, self.convolution_mode)
        return InputType.convolutional(h, w, it.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s = _pair(self.kernel_size), _pair(self.stride)
        pt = self.pooling_type.lower()
        if pt not in ("max", "avg", "pnorm"):
            raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
        xc = x.permute(0, 3, 1, 2)
        pads = _padding_cfg(self.convolution_mode, self.padding, xc, k, s)
        if pt == "max":
            out = F.max_pool2d(_pad_nchw(xc, pads, float("-inf")), k, s)
        elif pt == "avg":
            out = F.avg_pool2d(_pad_nchw(xc, pads), k, s)
        else:
            p = float(self.pnorm)
            sums = F.avg_pool2d(_pad_nchw(xc.abs() ** p, pads), k, s) * (k[0] * k[1])
            out = sums ** (1.0 / p)
        return out.permute(0, 2, 3, 1), state


def separable_conv_nhwc(x, w_dw, w_pw, stride, padding, mode):
    """Depthwise (``groups`` = input channels) then 1x1 pointwise
    convolution, NHWC in and out."""
    xc = x.permute(0, 3, 1, 2)
    k, s = _pair(w_dw.shape[:2]), _pair(stride)
    xc = _pad_nchw(xc, _padding_cfg(mode, padding, xc, k, s))
    dw = w_dw.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    z = F.conv2d(xc, dw, stride=s, groups=xc.shape[1])
    pw = w_pw.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(z, pw).permute(0, 2, 3, 1)


def _pads_1d(mode, padding, size, k, s, dilation=1):
    if mode == "same":
        return _same_pads(size, k, s, dilation)
    return int(padding), int(padding)


def conv1d_nwc(x, w_wio, stride, padding, mode, dilation=1):
    """(batch, time, channels) input × (k, C_in, C_out) kernel → (batch,
    time', C_out), with the padding modes of :func:`conv2d_nhwc`."""
    xc = x.permute(0, 2, 1)
    k = int(w_wio.shape[0])
    lo, hi = _pads_1d(mode, padding, xc.shape[2], k, int(stride), int(dilation))
    if lo or hi:
        xc = F.pad(xc, (lo, hi))
    z = F.conv1d(xc, w_wio.permute(2, 1, 0), stride=int(stride), dilation=int(dilation))
    return z.permute(0, 2, 1)


def _conv_shape(layer, it: InputType, dilation=(1, 1)) -> InputType:
    kh, kw = _pair(layer.kernel_size)
    sh, sw = _pair(layer.stride)
    ph, pw = _pair(layer.padding)
    dh, dw = _pair(dilation)
    h = _conv_out(it.height, kh, sh, ph, layer.convolution_mode, dh)
    w = _conv_out(it.width, kw, sw, pw, layer.convolution_mode, dw)
    return InputType.convolutional(h, w, layer.n_out)


def _conv1d_shape(layer, it: InputType, n_out: int) -> InputType:
    t = it.timeseries_length
    if t is not None:
        t = _conv_out(t, layer.kernel_size, layer.stride, layer.padding,
                      layer.convolution_mode, getattr(layer, "dilation", 1))
    return InputType.recurrent(n_out, t)


def _separable_init(layer, gen, it: InputType, device) -> dict:
    kh, kw = _pair(layer.kernel_size)
    c_in = layer.n_in or it.channels
    dw_out = c_in * layer.depth_multiplier
    params = {
        "W_dw": init_weights(gen, (kh, kw, 1, dw_out), kh * kw,
                             kh * kw * layer.depth_multiplier, layer.weight_init,
                             layer.dist, device),
        "W_pw": init_weights(gen, (1, 1, dw_out, layer.n_out), dw_out, layer.n_out,
                             layer.weight_init, layer.dist, device),
    }
    if layer.has_bias:
        params["b"] = torch.full((layer.n_out,), float(layer.bias_init), device=device)
    return params


def _conv1d_init(layer, gen, it: InputType, device) -> dict:
    c_in = layer.n_in or it.size
    k = layer.kernel_size
    params = {"W": init_weights(gen, (k, c_in, layer.n_out), c_in * k, layer.n_out * k,
                                layer.weight_init, layer.dist, device)}
    if layer.has_bias:
        params["b"] = torch.full((layer.n_out,), float(layer.bias_init), device=device)
    return params


@register_layer
@dataclasses.dataclass(frozen=True)
class SeparableConvolution2D(BaseLayer):
    """Depthwise-separable convolution: depthwise (``depth_multiplier``
    outputs an input channel), then 1x1 pointwise."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    depth_multiplier: int = 1
    has_bias: bool = True
    activation: str = "identity"

    def input_kind(self):
        return "cnn"

    def regularizable(self):
        return ("W_dw", "W_pw")

    def output_type(self, it: InputType) -> InputType:
        return _conv_shape(self, it)

    def with_n_in(self, n_in):
        return self

    def init(self, gen, it: InputType, device):
        return _separable_init(self, gen, it, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        z = separable_conv_nhwc(x, params["W_dw"], params["W_pw"], self.stride,
                                self.padding, self.convolution_mode)
        if self.has_bias:
            z = z + params["b"]
        return get_activation(self.activation)(z), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling."""

    size: Tuple[int, int] = (2, 2)

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        sh, sw = _pair(self.size)
        return InputType.convolutional(it.height * sh, it.width * sw, it.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), state


def _four(v) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) from four values or (h, w) symmetric."""
    if len(v) == 2:
        return (int(v[0]), int(v[0]), int(v[1]), int(v[1]))
    return tuple(int(e) for e in v)


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(Layer):
    """Spatial zero padding; ``padding`` = (top, bottom, left, right) or
    (h, w) symmetric."""

    padding: Tuple[int, ...] = (1, 1)

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        t, b, l, r = _four(self.padding)
        return InputType.convolutional(it.height + t + b, it.width + l + r, it.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = _four(self.padding)
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Convolution1DLayer(BaseLayer):
    """1-D convolution over (batch, time, channels), WIO kernel."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "truncate"
    dilation: int = 1
    has_bias: bool = True
    activation: str = "identity"

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    def output_type(self, it: InputType) -> InputType:
        return _conv1d_shape(self, it, self.n_out)

    def init(self, gen, it: InputType, device):
        return _conv1d_init(self, gen, it, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        z = conv1d_nwc(x, params["W"], self.stride, self.padding, self.convolution_mode,
                       self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return get_activation(self.activation)(z), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(Layer):
    """1-D pooling over (batch, time, channels): max | avg | pnorm."""

    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    pooling_type: str = "max"
    pnorm: int = 2
    convolution_mode: str = "truncate"

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    def output_type(self, it: InputType) -> InputType:
        return _conv1d_shape(self, it, it.size)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s = int(self.kernel_size), int(self.stride)
        pt = self.pooling_type.lower()
        if pt not in ("max", "avg", "pnorm"):
            raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
        xc = x.permute(0, 2, 1)
        pads = _pads_1d(self.convolution_mode, self.padding, xc.shape[2], k, s)
        if pt == "max":
            out = F.max_pool1d(F.pad(xc, pads, value=float("-inf")), k, s)
        elif pt == "avg":
            out = F.avg_pool1d(F.pad(xc, pads), k, s)
        else:
            p = float(self.pnorm)
            out = (F.avg_pool1d(F.pad(xc.abs() ** p, pads), k, s) * k) ** (1.0 / p)
        return out.permute(0, 2, 1), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling1D(Layer):
    """Repeat each timestep ``size`` times."""

    size: int = 2

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    def output_type(self, it: InputType) -> InputType:
        t = it.timeseries_length
        return InputType.recurrent(it.size, None if t is None else t * self.size)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.repeat_interleave(self.size, dim=1), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping2D(Layer):
    """Spatial cropping; ``cropping`` = (top, bottom, left, right) or (h, w)."""

    cropping: Tuple[int, ...] = (0, 0)

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        t, b, l, r = _four(self.cropping)
        h, w = it.height - t - b, it.width - l - r
        if h <= 0 or w <= 0:
            raise ValueError(f"Cropping {self.cropping} consumes the whole "
                             f"{it.height}x{it.width} input")
        return InputType.convolutional(h, w, it.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = _four(self.cropping)
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :], state


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping1D(Layer):
    """Temporal cropping; ``cropping`` = (left, right)."""

    cropping: Tuple[int, int] = (0, 0)

    def input_kind(self):
        return "cnn1d"

    def output_type(self, it: InputType) -> InputType:
        l, r = self.cropping
        t = None if it.timeseries_length is None else it.timeseries_length - l - r
        if t is not None and t <= 0:
            raise ValueError(f"Cropping {self.cropping} consumes the whole "
                             f"length-{it.timeseries_length} sequence")
        return InputType.recurrent(it.size, t)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        l, r = self.cropping
        return x[:, l:x.shape[1] - r, :], state


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPadding1DLayer(Layer):
    """Temporal zero padding; ``padding`` = (left, right)."""

    padding: Tuple[int, int] = (1, 1)

    def input_kind(self):
        return "cnn1d"

    def output_type(self, it: InputType) -> InputType:
        l, r = self.padding
        t = None if it.timeseries_length is None else it.timeseries_length + l + r
        return InputType.recurrent(it.size, t)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        l, r = self.padding
        return F.pad(x, (0, 0, int(l), int(r))), state


# ---------------------------------------------------------------------------
# Fused Conv→BN→Activation(→residual add) block (the ``perf/fusion.py``
# rewriter's target). Train-mode BN goes through ``fused_bn_act_train``: a
# ``torch.autograd.Function`` whose forward is the ``bn_act_fwd`` kernel and
# whose backward is the ``bn_act_bwd`` kernel. It saves only z (which the
# conv's weight gradient keeps anyway), gamma, beta, res and the O(C) mean
# and inv-std, and recomputes x-hat and the pre-activation in the backward
# (the In-Place Activated BatchNorm recipe, Bulò et al., CVPR 2018).

class _FusedBNAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act, eps, z, gamma, beta, res):
        out, mean, var, inv = bn_act.bn_act_fwd(act, eps, z, gamma, beta, res)
        ctx.act, ctx.eps = act, eps
        ctx.save_for_backward(z, gamma, beta, res, mean, inv)
        # (mean, var) only feed the running-stat update: no gradient
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        z, gamma, beta, res, mean, inv = ctx.saved_tensors
        dz, dgamma, dbeta, dpre = bn_act.bn_act_bwd(ctx.act, ctx.eps, z, gamma,
                                                    beta, res, mean, inv, dout)
        dres = None if res is None else dpre.to(res.dtype)
        return (None, None, dz, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                dres)


def fused_bn_act_train(act: str, eps: float, z, gamma, beta, res=None):
    """Train-mode BN + activation (+ residual add before the activation)
    over the conv output ``z`` (channels last). Returns ``(out, mean,
    var)``; mean and var are the batch stats for the running buffers and
    carry no gradient."""
    return _FusedBNAct.apply(act, float(eps), z, gamma, beta, res)


def _fused_bn_tail(layer, params, state, z, train, res=None):
    """The BN(+residual)(+activation) tail of a fused block: train mode
    through :func:`fused_bn_act_train`, eval mode through the running-stat
    scale/shift as plain tensor code (no kernel)."""
    gamma, beta = params["gamma"], params["beta"]
    if train:
        out, mean, var = fused_bn_act_train(layer.activation, layer.eps,
                                            z.contiguous(), gamma, beta,
                                            None if res is None else res.contiguous())
        return out, running_update(layer.decay, state, mean, var)
    scale, shift, _ = scale_shift(layer.eps, gamma, beta, state["mean"],
                                  state["var"])
    return bn_act.bn_act_apply_plain(layer.activation, z, scale, shift, res), state


@register_layer
@dataclasses.dataclass(frozen=True)
class FusedConvBNActivation(BaseLayer):
    """Conv → train-mode BatchNorm → activation (optionally + a residual
    add before the activation) as one layer. Produced by ``perf.fusion.fuse``
    from ConvolutionLayer → BatchNormalization → ActivationLayer
    (→ ElementWiseVertex add) chains. ``residual=True`` (ComputationGraph
    only) takes the add's other operand as a second vertex input. Params are
    the conv's (W[, b]) plus the BN's (gamma, beta); the BN running stats
    are the layer state."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = False
    activation: str = "relu"
    # BatchNormalization fields (gamma/beta are the INIT values)
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    residual: bool = False

    def input_kind(self):
        return "cnn"

    def output_type(self, it: InputType) -> InputType:
        return _conv_shape(self, it, self.dilation)

    def with_n_in(self, n_in):
        return self  # n_in is channels, set from the input type in init

    def init(self, gen, it: InputType, device):
        return _fused_bn_init(self, ConvolutionLayer.init(self, gen, it, device)[0], device)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None, res=None):
        bump_active("fusion.fused_block")
        x = dropout_input(x, self.dropout, train, rng)
        z = conv2d_nhwc(x, params["W"], self.stride, self.padding,
                        self.convolution_mode, self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return _fused_bn_tail(self, params, state, z, train, res)


def _fused_bn_init(layer, params: dict, device):
    params["gamma"] = torch.full((layer.n_out,), float(layer.gamma), device=device)
    params["beta"] = torch.full((layer.n_out,), float(layer.beta), device=device)
    state = {"mean": torch.zeros((layer.n_out,), device=device),
             "var": torch.ones((layer.n_out,), device=device)}
    return params, state


@register_layer
@dataclasses.dataclass(frozen=True)
class FusedSeparableConvBNActivation(BaseLayer):
    """SeparableConvolution2D → train-mode BatchNorm → activation as one
    layer, the BN tail through the ``bn_act_fwd`` / ``bn_act_bwd`` kernels
    (:func:`fused_bn_act_train`). Produced by ``perf.fusion.fuse``;
    non-residual only."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    depth_multiplier: int = 1
    has_bias: bool = False
    activation: str = "relu"
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0

    def input_kind(self):
        return "cnn"

    def regularizable(self):
        return ("W_dw", "W_pw")

    def output_type(self, it: InputType) -> InputType:
        return _conv_shape(self, it)

    def with_n_in(self, n_in):
        return self

    def init(self, gen, it: InputType, device):
        return _fused_bn_init(self, _separable_init(self, gen, it, device), device)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        bump_active("fusion.fused_block")
        x = dropout_input(x, self.dropout, train, rng)
        z = separable_conv_nhwc(x, params["W_dw"], params["W_pw"], self.stride,
                                self.padding, self.convolution_mode)
        if self.has_bias:
            z = z + params["b"]
        return _fused_bn_tail(self, params, state, z, train)


@register_layer
@dataclasses.dataclass(frozen=True)
class FusedConv1DBNActivation(BaseLayer):
    """Convolution1DLayer → train-mode BatchNorm → activation as one layer
    over (batch, time, channels): the BN tail normalises over all but the
    last axis, through the same kernels as the 2-D block."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "truncate"
    dilation: int = 1
    has_bias: bool = False
    activation: str = "relu"
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    def output_type(self, it: InputType) -> InputType:
        return _conv1d_shape(self, it, self.n_out)

    def init(self, gen, it: InputType, device):
        return _fused_bn_init(self, _conv1d_init(self, gen, it, device), device)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        bump_active("fusion.fused_block")
        x = dropout_input(x, self.dropout, train, rng)
        z = conv1d_nwc(x, params["W"], self.stride, self.padding, self.convolution_mode,
                       self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return _fused_bn_tail(self, params, state, z, train)
