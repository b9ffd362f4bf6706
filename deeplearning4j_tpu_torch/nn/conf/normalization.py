"""BatchNormalization and LocalResponseNormalization (counterpart of
``deeplearning4j_tpu/nn/conf/normalization.py``), as plain tensor code.

Numerics are the JAX package's, branch for branch:

- train mode, bf16/f16 input: single-pass float32 stats,
  ``var = max(E[x²] - mean², 0)``;
- train mode, other input: the centred two-pass mean and variance;
- running buffers: ``decay * old + (1 - decay) * batch`` with the
  **biased** (population) batch variance. ``F.batch_norm`` feeds the
  unbiased variance into its running buffer, so it is not used here;
- the normalisation folds to ``x * scale + shift`` with per-channel scale
  and shift computed in the stats dtype and cast to x's dtype.

The new running stats are returned as new tensors (computed without
autograd); the network copies them into its state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, Layer, register_layer

LOW_PRECISION = (torch.bfloat16, torch.float16)


def batch_stats(x: torch.Tensor):
    """Per-channel (mean, biased var) over all but the last axis."""
    axes = tuple(range(x.dim() - 1))
    if x.dtype in LOW_PRECISION:
        xf = x.float()
        n = xf.numel() // xf.shape[-1]
        mean = xf.sum(dim=axes) / n
        var = torch.clamp_min((xf * xf).sum(dim=axes) / n - mean * mean, 0.0)
    else:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
    return mean, var


def running_update(decay: float, state: dict, mean, var) -> dict:
    """New running buffers, outside autograd."""
    with torch.no_grad():
        return {"mean": decay * state["mean"] + (1.0 - decay) * mean.detach(),
                "var": decay * state["var"] + (1.0 - decay) * var.detach()}


def scale_shift(eps: float, gamma, beta, mean, var):
    """(scale, shift, inv) in the stats dtype."""
    inv = torch.rsqrt(var + eps)
    scale = gamma.to(var.dtype) * inv
    shift = beta.to(var.dtype) - mean * scale
    return scale, shift, inv


def normalize(x, scale, shift):
    return x * scale.to(x.dtype) + shift.to(x.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(BaseLayer):
    """Batch norm over the last (channel/feature) axis. Reference defaults:
    decay=0.9, eps=1e-5, lockGammaBeta=false."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma: float = 1.0  # fixed value when locked
    beta: float = 0.0

    def regularizable(self):
        return ()

    def init(self, gen, it: InputType, device):
        n = it.channels if it.kind == "cnn" else it.flat_size()
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.full((n,), float(self.gamma), device=device),
                      "beta": torch.full((n,), float(self.beta), device=device)}
        state = {"mean": torch.zeros((n,), device=device),
                 "var": torch.ones((n,), device=device)}
        return params, state

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if train:
            mean, var = batch_stats(x)
            new_state = running_update(self.decay, state, mean, var)
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        if self.lock_gamma_beta:
            gamma = torch.full_like(var, self.gamma)
            beta = torch.full_like(var, self.beta)
        else:
            gamma, beta = params["gamma"], params["beta"]
        scale, shift, _ = scale_shift(self.eps, gamma, beta, mean, var)
        return normalize(x, scale, shift), new_state


@register_layer
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(Layer):
    """Cross-channel LRN over NHWC (reference LocalResponseNormalization;
    defaults k=2, n=5, alpha=1e-4, beta=0.75):
    ``x / (k + alpha * S) ** beta``, S the sum of squares over a centred
    window of ``2 * (n // 2) + 1`` channels (the reference loops n/2 either
    side of the centre, so an even n covers n + 1), zero beyond the edges.
    ``alpha`` multiplies the sum as it is: ``F.local_response_norm``
    divides it by the window size, so it is not used."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def input_kind(self):
        return "cnn"

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        half = self.n // 2
        c = x.shape[-1]
        sq = F.pad(x * x, (half, half))
        summed = sq[..., 0:c]
        for i in range(1, 2 * half + 1):
            summed = summed + sq[..., i:i + c]
        return x / torch.pow(self.k + self.alpha * summed, self.beta), state
