"""Self-attention layers (counterpart of
``deeplearning4j_tpu/nn/conf/attention.py``): ``SelfAttentionLayer`` and the
pre-LN ``TransformerEncoderBlock``, over (batch, time, features).

Both share :func:`_attend`, which takes the JAX package's selection rule:
with no features mask and ``t >= 128``, the flash path
(``parallel/ring_attention.flash_self_attention``: the hand-written CUDA
kernels on the card, their plain versions on the CPU; differentiable
through the wrapper's ``torch.autograd.Function``, whose backward runs the
dK/dV and dQ kernels); otherwise the dense ``reference_attention`` with the
mask on the keys. Each forward call, in serving and in training, adds one
to :data:`counters` under the JAX package's names (``attention.flash``,
``attention.dense``); ``ParallelInference.stats()`` reports them. The
kernel takes every ``t`` and head dims up to 256, so the JAX package's
``attention.flash_fallback`` (a TPU block-shape refusal) has no
counterpart: an input the kernel does not take raises.

Parameters are nested as in the JAX package: ``{"q": {"W", "b"}, "k": ...,
"v": ..., "o": ...}``, plus ``ff1``/``ff2`` and ``ln1_g``/``ln1_b``/
``ln2_g``/``ln2_b`` in the block, so ``interop.params_from_jax`` carries
them leaf for leaf. The projections, LayerNorm and GELU are plain tensor
code, as they are jnp code there.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import ClassVar, Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, dropout_input, register_layer
from deeplearning4j_tpu_torch.nn.initializers import init_weights
from deeplearning4j_tpu_torch.parallel.ring_attention import (flash_self_attention,
                                                              reference_attention)

#: calls of each attention path since import (or since a caller reset them)
counters = {"attention.flash": 0, "attention.dense": 0}
_count_lock = threading.Lock()


def _count(name: str):
    with _count_lock:
        counters[name] += 1


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _unheads(x):
    """(b, h, t, dh) -> (b, t, h*dh); a view for the flash kernel's output,
    which comes back in the projections' (b, t, h, dh) layout."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _proj(p, x):
    z = x @ p["W"]
    return z + p["b"] if "b" in p else z


def _attend(params, x, mask, n_heads: int, causal: bool):
    """Multi-head attention over the nested q/k/v/o groups: the flash path
    when there is no mask and ``t >= 128``, the dense one otherwise."""
    q = _heads(_proj(params["q"], x), n_heads)
    k = _heads(_proj(params["k"], x), n_heads)
    v = _heads(_proj(params["v"], x), n_heads)
    if mask is None and q.shape[2] >= 128:
        _count("attention.flash")
        out = flash_self_attention(q, k, v, causal=causal)
    else:
        _count("attention.dense")  # masked or short sequence: by design
        out = reference_attention(q, k, v, causal=causal, key_mask=mask)
    return _proj(params["o"], _unheads(out))


def _group(layer, gen, din: int, dout: int, device) -> dict:
    g = {"W": init_weights(gen, (din, dout), din, dout, layer.weight_init, layer.dist,
                           device)}
    if layer.has_bias:
        g["b"] = torch.full((dout,), float(layer.bias_init), device=device)
    return g


def _qkvo_params(gen, n_in: int, d: int, layer, device) -> dict:
    return {key: _group(layer, gen, din, d, device)
            for key, din in (("q", n_in), ("k", n_in), ("v", n_in), ("o", d))}


def _zero_masked(x, mask):
    """Masked steps emit zeros, after the activation."""
    return x if mask is None else x * mask[..., None].to(x.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class SelfAttentionLayer(BaseLayer):
    """Multi-head self-attention. ``n_out`` is the model width (divisible
    by ``n_heads``); ``causal=True`` masks the future; a features mask
    becomes a key padding mask and masked steps emit zeros."""

    n_in: Optional[int] = None
    n_out: int = 0
    n_heads: int = 4
    causal: bool = False
    has_bias: bool = True
    activation: str = "identity"

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    #: a full-sequence layer: no carry for rnn_time_step or tBPTT
    supports_stateful: ClassVar[bool] = False

    def regularizable(self):
        return ("q/W", "k/W", "v/W", "o/W")

    def output_type(self, it: InputType) -> InputType:
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by n_heads {self.n_heads}")
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        return _qkvo_params(gen, self.n_in or it.size, self.n_out, self, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        out = get_activation(self.activation)(
            _attend(params, x, mask, self.n_heads, self.causal))
        return _zero_masked(out, mask), state


@register_layer
@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(BaseLayer):
    """Pre-LN transformer block: LN -> MHA -> residual, LN -> FFN -> residual.
    Width-preserving (n_out == n_in); ``ff_size`` defaults to 4 * width."""

    n_in: Optional[int] = None
    n_out: int = 0              # model width; inferred from the input when 0
    n_heads: int = 4
    ff_size: int = 0
    causal: bool = False
    has_bias: bool = True
    ff_activation: str = "gelu"
    activation: str = "identity"

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    supports_stateful: ClassVar[bool] = False

    def regularizable(self):
        return ("q/W", "k/W", "v/W", "o/W", "ff1/W", "ff2/W")

    def _width(self, it: InputType) -> int:
        return self.n_out or self.n_in or it.size

    def output_type(self, it: InputType) -> InputType:
        d = self._width(it)
        if it.size and d != it.size:
            raise ValueError(f"TransformerEncoderBlock is residual: width {d} must match "
                             f"input size {it.size}")
        if d % self.n_heads:
            raise ValueError(f"width {d} not divisible by n_heads {self.n_heads}")
        return InputType.recurrent(d, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        d = self._width(it)
        ff = self.ff_size or 4 * d
        params = _qkvo_params(gen, d, d, self, device)
        params["ff1"] = _group(self, gen, d, ff, device)
        params["ff2"] = _group(self, gen, ff, d, device)
        for name in ("ln1", "ln2"):
            params[f"{name}_g"] = torch.ones((d,), device=device)
            params[f"{name}_b"] = torch.zeros((d,), device=device)
        return params, {}

    @staticmethod
    def _ln(x, g, b, eps=1e-5):
        """LayerNorm with the population variance, eps inside the rsqrt."""
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, correction=0, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * g + b

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        att_in = self._ln(x, params["ln1_g"], params["ln1_b"])
        x = x + _attend(params, att_in, mask, self.n_heads, self.causal)
        ff_in = self._ln(x, params["ln2_g"], params["ln2_b"])
        h = get_activation(self.ff_activation)(_proj(params["ff1"], ff_in))
        x = get_activation(self.activation)(x + _proj(params["ff2"], h))
        return _zero_masked(x, mask), state


__all__ = ["SelfAttentionLayer", "TransformerEncoderBlock", "counters"]
