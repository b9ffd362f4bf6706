"""Dropout variants, parameter constraints and weight noise (counterpart of
``deeplearning4j_tpu/nn/conf/regularization.py``).

Three families, each a frozen dataclass with the JAX package's class and
field names, registered with the layer registry so that a layer's
``dropout=``, ``constraints=`` and ``weight_noise=`` fields round-trip
through the configuration JSON:

- ``IDropout`` (``Dropout``, ``AlphaDropout``, ``GaussianDropout``,
  ``GaussianNoise``) transforms a layer's input at train time;
- ``BaseConstraint`` (``MaxNormConstraint``, ``MinMaxNormConstraint``,
  ``UnitNormConstraint``, ``NonNegativeConstraint``) maps a parameter after
  each updater step;
- ``IWeightNoise`` (``DropConnect``, ``WeightNoise``) transforms a layer's
  weights in the training forward.

Every random transform is split in two: ``draw`` takes the random numbers
it needs from an explicit ``torch.Generator`` (uniforms where the JAX
package draws a Bernoulli mask, since ``jax.random.bernoulli(k, p)`` is
``uniform(k) < p``; standard normals where it draws Gaussian noise), and
``apply_drawn`` is the deterministic rest. The parity tests feed both
packages the same draws, since threefry and Philox differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import layer_to_dict, register_layer
from deeplearning4j_tpu_torch.nn.initializers import Distribution


def _uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device)


def _normal(shape, gen, device, dtype):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


# ------------------------------------------------------------------ dropout
@dataclasses.dataclass(frozen=True)
class IDropout:
    """Transforms a layer's input at train time (reference IDropout)."""

    def active(self) -> bool:
        return True

    def draw(self, shape, gen: torch.Generator, device, dtype):
        raise NotImplementedError

    def apply_drawn(self, x, r):
        raise NotImplementedError

    def apply(self, x, rng: Optional[torch.Generator], train: bool):
        if not train or rng is None or not self.active():
            return x
        return self.apply_drawn(x, self.draw(x.shape, rng, x.device, x.dtype))

    def to_dict(self):
        return layer_to_dict(self)


@register_layer
@dataclasses.dataclass(frozen=True)
class Dropout(IDropout):
    """Inverted dropout; ``p`` is the retain probability (DL4J 0.9)."""

    p: float = 0.5

    def active(self):
        return 0.0 < self.p < 1.0

    def draw(self, shape, gen, device, dtype):
        return _uniform(shape, gen, device)

    def apply_drawn(self, x, r):
        return torch.where(r < self.p, x / self.p,
                           torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class AlphaDropout(IDropout):
    """SELU-preserving dropout: dropped units take alpha', and an affine
    correction keeps zero mean and unit variance. ``p`` is the retain
    probability."""

    p: float = 0.95
    _ALPHA_PRIME = -1.7580993408473766

    def active(self):
        return 0.0 < self.p < 1.0

    def draw(self, shape, gen, device, dtype):
        return _uniform(shape, gen, device)

    def apply_drawn(self, x, r):
        p, ap = self.p, self._ALPHA_PRIME
        a = (p + ap * ap * p * (1 - p)) ** -0.5
        b = -a * (1 - p) * ap
        kept = torch.where(r < p, x, torch.full((), ap, dtype=x.dtype, device=x.device))
        return (a * kept + b).to(x.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class GaussianDropout(IDropout):
    """Multiplicative noise N(1, rate / (1 - rate))."""

    rate: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"GaussianDropout rate must be in [0, 1); got {self.rate}")

    def active(self):
        return self.rate > 0.0

    def draw(self, shape, gen, device, dtype):
        return _normal(shape, gen, device, dtype)

    def apply_drawn(self, x, r):
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * r)


@register_layer
@dataclasses.dataclass(frozen=True)
class GaussianNoise(IDropout):
    """Additive noise N(0, stddev) at train time."""

    stddev: float = 0.1

    def active(self):
        return self.stddev > 0.0

    def draw(self, shape, gen, device, dtype):
        return _normal(shape, gen, device, dtype)

    def apply_drawn(self, x, r):
        return x + self.stddev * r


# -------------------------------------------------------------- constraints
@dataclasses.dataclass(frozen=True, kw_only=True)
class BaseConstraint:
    """A map applied to a parameter after each update. Norms reduce over
    every axis but the last (per output unit: columns of a dense W, filters
    of a conv kernel)."""

    apply_to_weights: bool = True
    apply_to_biases: bool = False

    def apply(self, param):
        raise NotImplementedError

    def to_dict(self):
        return layer_to_dict(self)

    @staticmethod
    def _norms(w):
        dims = tuple(range(w.dim() - 1)) if w.dim() > 1 else (0,)
        return torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True) + 1e-12)


@register_layer
@dataclasses.dataclass(frozen=True)
class MaxNormConstraint(BaseConstraint):
    """Rescale units whose L2 norm exceeds ``max_norm``."""

    max_norm: float = 2.0

    def apply(self, param):
        n = self._norms(param)
        return param * (torch.clamp_max(n, self.max_norm) / n)


@register_layer
@dataclasses.dataclass(frozen=True)
class MinMaxNormConstraint(BaseConstraint):
    """Clamp unit norms into [min_norm, max_norm], blended by ``rate``."""

    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def apply(self, param):
        n = self._norms(param)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        return param * (self.rate * (clipped / n) + (1.0 - self.rate))


@register_layer
@dataclasses.dataclass(frozen=True)
class UnitNormConstraint(BaseConstraint):
    """Unit L2 norm per unit."""

    def apply(self, param):
        return param / self._norms(param)


@register_layer
@dataclasses.dataclass(frozen=True)
class NonNegativeConstraint(BaseConstraint):
    """Clamp parameters at zero."""

    def apply(self, param):
        return torch.clamp_min(param, 0.0)


# ------------------------------------------------------------- weight noise
@dataclasses.dataclass(frozen=True, kw_only=True)
class IWeightNoise:
    """Transforms weights in the training forward (reference IWeightNoise)."""

    apply_to_bias: bool = False

    def draw(self, shape, gen: torch.Generator, device, dtype):
        raise NotImplementedError

    def apply_drawn(self, w, r):
        raise NotImplementedError

    def apply_to_param(self, w, gen: torch.Generator):
        return self.apply_drawn(w, self.draw(w.shape, gen, w.device, w.dtype))

    def to_dict(self):
        return layer_to_dict(self)


@register_layer
@dataclasses.dataclass(frozen=True)
class DropConnect(IWeightNoise):
    """Bernoulli weight dropout; ``p`` is the retain probability, with
    inverted scaling."""

    p: float = 0.5

    def draw(self, shape, gen, device, dtype):
        return _uniform(shape, gen, device)

    def apply_drawn(self, w, r):
        if self.p >= 1.0 or self.p <= 0.0:
            return w
        return torch.where(r < self.p, w / self.p,
                           torch.zeros((), dtype=w.dtype, device=w.device)).to(w.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class WeightNoise(IWeightNoise):
    """Additive or multiplicative noise from ``dist``, or N(0, stddev)
    where ``dist`` is None. The draw is the noise itself."""

    dist: Optional[Distribution] = None
    additive: bool = True
    stddev: float = 0.01

    def draw(self, shape, gen, device, dtype):
        if self.dist is not None:
            return self.dist.sample(gen, tuple(shape), device, dtype)
        return self.stddev * _normal(shape, gen, device, dtype)

    def apply_drawn(self, w, r):
        return w + r if self.additive else w * r
