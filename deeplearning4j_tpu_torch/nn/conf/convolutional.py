"""Convolution and pooling layers (counterpart of
``deeplearning4j_tpu/nn/conf/convolutional.py``: ``ConvolutionLayer``,
``SubsamplingLayer`` and the fused ``FusedConvBNActivation`` block).

Public layouts are the JAX package's: NHWC activations and HWIO kernels.
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
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        h = _conv_out(it.height, kh, sh, ph, self.convolution_mode, dh)
        w = _conv_out(it.width, kw, sw, pw, self.convolution_mode, dw)
        return InputType.convolutional(h, w, self.n_out)

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
        return ConvolutionLayer.output_type(self, it)

    def with_n_in(self, n_in):
        return self  # n_in is channels, set from the input type in init

    def init(self, gen, it: InputType, device):
        params, _ = ConvolutionLayer.init(self, gen, it, device)
        params["gamma"] = torch.full((self.n_out,), float(self.gamma), device=device)
        params["beta"] = torch.full((self.n_out,), float(self.beta), device=device)
        state = {"mean": torch.zeros((self.n_out,), device=device),
                 "var": torch.ones((self.n_out,), device=device)}
        return params, state

    def apply(self, params, state, x, *, train=False, rng=None, mask=None, res=None):
        x = dropout_input(x, self.dropout, train, rng)
        z = conv2d_nhwc(x, params["W"], self.stride, self.padding,
                        self.convolution_mode, self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return _fused_bn_tail(self, params, state, z, train, res)
