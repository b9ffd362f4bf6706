"""The recurrent layer family (counterpart of
``deeplearning4j_tpu/nn/conf/recurrent.py``): ``LSTM``, ``GravesLSTM``
(peepholes), ``Bidirectional``, ``GravesBidirectionalLSTM``,
``LastTimeStep``, ``SimpleRnn``, ``GRU``, and the sequence layers
``RnnOutputLayer``, ``EmbeddingLayer`` and ``EmbeddingSequenceLayer``.

Recurrent activations are (batch, time, size), as in the JAX package. A
recurrent layer gives ``init_carry(batch, dtype, device)`` and
``apply_seq(params, carry, x, *, train, rng, mask) -> (out, new_carry)``,
so that a network can carry state across tBPTT windows and
``rnn_time_step`` calls; ``apply`` runs one sequence from zero state.

- The input projection of every timestep is one ``torch.matmul``
  ``(b*t, n_in) @ (n_in, k*n)``, hoisted out of the time loop; the loop
  (a Python loop, where the JAX package has ``lax.scan``) adds the
  recurrent product and applies the gates. Gradients are autograd through
  the loop. ``torch.nn.LSTM`` / cuDNN are not used: they have no
  peepholes and lay their biases out otherwise.
- LSTM gates are fused in the order (i, f, g, o), with the forget gate's
  bias starting at ``forget_gate_bias_init`` (1.0); GRU's in the order
  (z, r, h).
- A (batch, time) features mask holds the carry through masked steps
  (``h = keep*h + (1-keep)*h_prev``, the same for c) and zeroes their
  output.
- The embeddings take integer ids and gather rows of ``W`` (vocab, n_out);
  ids are cast to ``long`` for the gather, so callers may pass int32,
  int64 or integer-valued floats.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayer, BaseOutputLayer,
                                                     dropout_input, register_layer)
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

    def is_recurrent(self):
        return True

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
    #: features are (batch, time) ids, not (batch, time, channels)
    takes_index_sequence: ClassVar[bool] = True

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        return _table(self, gen, self.n_in or it.size, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.dim() == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        return params["W"][x.long()], state


def _time_loop(xw, carry, mask, cell):
    """Run ``cell(xw_t, carry) -> new carry`` (a dict holding "h") over the
    time axis of ``xw`` (b, t, k). Under a (b, t) mask a masked step keeps
    every carry entry and outputs zero. Returns ((b, t, n) outputs, carry)."""
    outs = []
    for s in range(xw.shape[1]):
        new = cell(xw[:, s], carry)
        if mask is None:
            out = new["h"]
        else:
            keep = mask[:, s, None].to(new["h"].dtype)
            new = {k: keep * v + (1.0 - keep) * carry[k] for k, v in new.items()}
            out = keep * new["h"]
        carry = new
        outs.append(out)
    return torch.stack(outs, dim=1), carry


def _project(x, params):
    """The input projection of every timestep at once: (b, t, k)."""
    b, t, _ = x.shape
    return (x.reshape(b * t, -1) @ params["W"] + params["b"]).reshape(b, t, -1)


@dataclasses.dataclass(frozen=True)
class BaseRecurrentLayer(BaseLayer):
    """The recurrent contract: carries and sequence application."""

    def is_recurrent(self):
        return True

    def input_kind(self):
        return "rnn"

    def init_carry(self, batch: int, dtype=torch.float32, device=None) -> dict:
        raise NotImplementedError

    def apply_seq(self, params, carry, x, *, train=False, rng=None, mask=None):
        """(out, new_carry); x is (batch, time, n_in)."""
        raise NotImplementedError

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        out, _ = self.apply_seq(params, carry, x, train=train, rng=rng, mask=mask)
        return out, state


def _zeros(batch, n, dtype, device) -> torch.Tensor:
    return torch.zeros((batch, n), dtype=dtype, device=device)


@register_layer
@dataclasses.dataclass(frozen=True)
class LSTM(BaseRecurrentLayer):
    """Standard LSTM (reference nn/conf/layers/LSTM.java, no peepholes)."""

    n_in: Optional[int] = None
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def regularizable(self):
        return ("W", "U")

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        n_in, n = self.n_in or it.size, self.n_out
        b = torch.zeros((4 * n,), device=device)
        b[n:2 * n] = self.forget_gate_bias_init
        return {"W": init_weights(gen, (n_in, 4 * n), n_in, n, self.weight_init,
                                  self.dist, device),
                "U": init_weights(gen, (n, 4 * n), n, n, self.weight_init, self.dist,
                                  device),
                "b": b}, {}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": _zeros(batch, self.n_out, dtype, device),
                "c": _zeros(batch, self.n_out, dtype, device)}

    def _gates(self, z, c_prev, params):
        n = self.n_out
        act, gate = get_activation(self.activation), get_activation(self.gate_activation)
        i = gate(z[:, 0 * n:1 * n])
        f = gate(z[:, 1 * n:2 * n])
        g = act(z[:, 2 * n:3 * n])
        o = gate(z[:, 3 * n:4 * n])
        c = f * c_prev + i * g
        return o * act(c), c

    def apply_seq(self, params, carry, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        U = params["U"]

        def cell(xw_t, c):
            h, cc = self._gates(xw_t + c["h"] @ U, c["c"], params)
            return {"h": h, "c": cc}

        return _time_loop(_project(x, params), carry, mask, cell)


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference nn/conf/layers/GravesLSTM.java):
    diagonal peepholes c_{t-1} into the i and f gates, the new c_t into o."""

    def init(self, gen, it: InputType, device):
        params, state = super().init(gen, it, device)
        n = self.n_out
        for k in ("p_i", "p_f", "p_o"):
            params[k] = init_weights(gen, (n,), n, n, "uniform", None, device)
        return params, state

    def _gates(self, z, c_prev, params):
        n = self.n_out
        act, gate = get_activation(self.activation), get_activation(self.gate_activation)
        i = gate(z[:, 0 * n:1 * n] + c_prev * params["p_i"])
        f = gate(z[:, 1 * n:2 * n] + c_prev * params["p_f"])
        g = act(z[:, 2 * n:3 * n])
        c = f * c_prev + i * g
        o = gate(z[:, 3 * n:4 * n] + c * params["p_o"])
        return o * act(c), c


def _flip_time(x, mask):
    """Reverse the time axis; under a mask, reverse only each sequence's
    valid prefix (the padding stays in place)."""
    if mask is None:
        return torch.flip(x, dims=(1,))
    t = x.shape[1]
    lengths = mask.sum(dim=1).to(torch.int64)                      # (b,)
    idx = torch.arange(t, device=x.device)[None, :]                # (1, t)
    src = lengths[:, None] - 1 - idx
    src = torch.where(src >= 0, src, idx)
    return torch.take_along_dim(x, src[..., None], dim=1)


_COMBINE = {"concat": lambda f, b: torch.cat([f, b], dim=-1),
            "add": lambda f, b: f + b,
            "mul": lambda f, b: f * b,
            "average": lambda f, b: 0.5 * (f + b)}


@register_layer
@dataclasses.dataclass(frozen=True)
class Bidirectional(BaseRecurrentLayer):
    """The wrapped recurrent layer run forward and time-reversed, combined by
    ``mode``: add | mul | average | concat. Parameters nest as ``fwd`` and
    ``bwd``. Carrying state across windows or steps is not valid for the
    backward direction, so ``rnn_time_step`` refuses it and tBPTT runs
    each window from zero state."""

    layer: Optional[LSTM] = None
    mode: str = "concat"

    supports_stateful: ClassVar[bool] = False

    def regularizable(self):
        inner = self.layer.regularizable() if self.layer is not None else ()
        return tuple(f"{d}/{k}" for d in ("fwd", "bwd") for k in inner)

    def output_type(self, it: InputType) -> InputType:
        inner = self.layer.output_type(it)
        n = inner.size * 2 if self.mode == "concat" else inner.size
        return InputType.recurrent(n, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        fwd, _ = self.layer.init(gen, it, device)
        bwd, _ = self.layer.init(gen, it, device)
        return {"fwd": fwd, "bwd": bwd}, {}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return {d: self.layer.init_carry(batch, dtype, device) for d in ("fwd", "bwd")}

    def apply_seq(self, params, carry, x, *, train=False, rng=None, mask=None):
        if self.mode not in _COMBINE:
            raise ValueError(f"Unknown bidirectional mode '{self.mode}'")
        out_f, c_f = self.layer.apply_seq(params["fwd"], carry["fwd"], x, train=train,
                                          rng=rng, mask=mask)
        out_b, c_b = self.layer.apply_seq(params["bwd"], carry["bwd"], _flip_time(x, mask),
                                          train=train, rng=rng, mask=mask)
        out = _COMBINE[self.mode](out_f, _flip_time(out_b, mask))
        return out, {"fwd": c_f, "bwd": c_b}

    def with_n_in(self, n_in):
        if self.layer is not None and getattr(self.layer, "n_in", 0) in (None, 0):
            return dataclasses.replace(self, layer=self.layer.with_n_in(n_in))
        return self


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(Bidirectional):
    """Bidirectional GravesLSTM with summed outputs (reference
    nn/conf/layers/GravesBidirectionalLSTM.java)."""

    mode: str = "add"

    def __post_init__(self):
        if self.layer is None:
            raise ValueError("GravesBidirectionalLSTM requires layer=GravesLSTM(...)")


@register_layer
@dataclasses.dataclass(frozen=True)
class LastTimeStep(BaseRecurrentLayer):
    """The wrapped recurrent layer's last (unmasked) timestep, as a
    feed-forward activation; its parameters are the wrapped layer's."""

    layer: Optional[LSTM] = None

    def regularizable(self):
        return self.layer.regularizable() if self.layer is not None else ()

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.layer.output_type(it).size)

    def init(self, gen, it: InputType, device):
        return self.layer.init(gen, it, device)

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return self.layer.init_carry(batch, dtype, device)

    def apply_seq(self, params, carry, x, *, train=False, rng=None, mask=None):
        out, new_carry = self.layer.apply_seq(params, carry, x, train=train, rng=rng,
                                              mask=mask)
        if mask is None:
            return out[:, -1, :], new_carry
        last = torch.clamp_min(mask.sum(dim=1).to(torch.int64) - 1, 0)
        return torch.take_along_dim(out, last[:, None, None], dim=1)[:, 0, :], new_carry

    def with_n_in(self, n_in):
        if self.layer is not None and getattr(self.layer, "n_in", 0) in (None, 0):
            return dataclasses.replace(self, layer=self.layer.with_n_in(n_in))
        return self


@register_layer
@dataclasses.dataclass(frozen=True)
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla recurrence ``h_t = act(x_t W + h_{t-1} U + b)`` (the Keras
    SimpleRNN import target)."""

    n_in: Optional[int] = None
    n_out: int = 0
    activation: str = "tanh"

    def regularizable(self):
        return ("W", "U")

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        n_in, n = self.n_in or it.size, self.n_out
        return {"W": init_weights(gen, (n_in, n), n_in, n, self.weight_init, self.dist,
                                  device),
                "U": init_weights(gen, (n, n), n, n, self.weight_init, self.dist, device),
                "b": torch.zeros((n,), device=device)}, {}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": _zeros(batch, self.n_out, dtype, device)}

    def apply_seq(self, params, carry, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        act, U = get_activation(self.activation), params["U"]
        return _time_loop(_project(x, params), carry, mask,
                          lambda xw_t, c: {"h": act(xw_t + c["h"] @ U)})


@register_layer
@dataclasses.dataclass(frozen=True)
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit (the Keras GRU import target; gate order z, r,
    h). ``reset_after=False``: ``hh = act(xWh + (r*h)Uh + bh)``;
    ``reset_after=True``: ``hh = act(xWh + bh + r*(hUh + brh))`` with the
    recurrent bias ``br``. Then ``h = z*h_prev + (1-z)*hh``."""

    n_in: Optional[int] = None
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    reset_after: bool = False

    def regularizable(self):
        return ("W", "U")

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def init(self, gen, it: InputType, device):
        n_in, n = self.n_in or it.size, self.n_out
        params = {"W": init_weights(gen, (n_in, 3 * n), n_in, n, self.weight_init,
                                    self.dist, device),
                  "U": init_weights(gen, (n, 3 * n), n, n, self.weight_init, self.dist,
                                    device),
                  "b": torch.zeros((3 * n,), device=device)}
        if self.reset_after:
            params["br"] = torch.zeros((3 * n,), device=device)
        return params, {}

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": _zeros(batch, self.n_out, dtype, device)}

    def apply_seq(self, params, carry, x, *, train=False, rng=None, mask=None):
        x = dropout_input(x, self.dropout, train, rng)
        n = self.n_out
        act, gate = get_activation(self.activation), get_activation(self.gate_activation)
        U, br = params["U"], params.get("br")

        def cell(xw_t, c):
            h_prev = c["h"]
            if self.reset_after:
                hu = h_prev @ U + br
                z = gate(xw_t[:, :n] + hu[:, :n])
                r = gate(xw_t[:, n:2 * n] + hu[:, n:2 * n])
                hh = act(xw_t[:, 2 * n:] + r * hu[:, 2 * n:])
            else:
                z = gate(xw_t[:, :n] + h_prev @ U[:, :n])
                r = gate(xw_t[:, n:2 * n] + h_prev @ U[:, n:2 * n])
                hh = act(xw_t[:, 2 * n:] + (r * h_prev) @ U[:, 2 * n:])
            return {"h": z * h_prev + (1.0 - z) * hh}

        return _time_loop(_project(x, params), carry, mask, cell)


__all__ = ["BaseRecurrentLayer", "LSTM", "GravesLSTM", "Bidirectional",
           "GravesBidirectionalLSTM", "LastTimeStep", "SimpleRnn", "GRU",
           "RnnOutputLayer", "EmbeddingLayer", "EmbeddingSequenceLayer"]
