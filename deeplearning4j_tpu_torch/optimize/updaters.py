"""Updaters and learning-rate schedules (counterpart of
``deeplearning4j_tpu/optimize/updaters.py``).

The JAX package lowers each updater to an optax transformation. Here the
same algebra is written out as plain tensor code, per parameter tensor, so
that each step is optax's by construction:

- ``Sgd``: ``u = -lr * g``.
- ``Nesterovs``: ``t = g + m*t``; ``u = -lr * (g + m*t)`` (optax ``trace``,
  nesterov).
- ``Adam``: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g² + b2 nu``; bias
  correction by the step count ``k``: ``m̂ = mu / (1 - b1^k)``,
  ``v̂ = nu / (1 - b2^k)``; ``u = -lr * m̂ / (√v̂ + ε)``, ε outside the root.
- ``Nadam``: Adam with ``m̂ = b1 * mu/(1-b1^(k+1)) + (1-b1) * g/(1-b1^k)``.
- ``AdaMax``: ``nu = max(|g| + ε, b2 nu)``; ``u = -lr * m̂ / nu``.
- ``AdaGrad``: ``s = g² + s`` (s starts at 0.1);
  ``u = -lr * rsqrt(s + ε) * g`` where ``s > 0``.
- ``RmsProp``: ``nu = (1-d) g² + d nu``; ``u = -lr * rsqrt(nu + ε) * g``.
- ``AdaDelta``: ``eg = (1-ρ) g² + ρ eg``;
  ``d = √(ex + ε) / √(eg + ε) * g``; ``ex = (1-ρ) d² + ρ ex``; ``u = -d``.
- ``NoOp``: ``u = 0``.

The learning rate of step ``k`` (0 for the first update) is
``_schedule(...)(k)``. State is a dict per layer: ``{"count": int, <slot>:
tree}``, each slot's tree mirroring the layer's parameter tree, nested
groups (``{"q": {"W", "b"}, ...}``) included, as optax's state mirrors the
pytree. Bias corrections are computed in float32, as optax computes
``1 - decay**count``.

Each class also writes its direction over lists of tensors,
``_foreach_direction``: one ``torch._foreach_*`` call for each elementwise
operation of ``_direction``, in the same order and rounding, so that
``optimize/fused_update.py`` updates many small tensors at once with a
result bitwise equal to the per-tensor one. No fused foreach op (``addcmul``,
``lerp``) is used, since those round otherwise. One device difference is
kept: on CUDA a tensor divided by a host scalar is computed as a product
with the scalar's float32 reciprocal, where ``_foreach_div`` divides, so
the list form multiplies by that reciprocal on CUDA (``_div_scalar``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map

_UPDATER_REGISTRY = {}


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__.lower()] = cls
    return cls


def _schedule(base_lr, policy, decay_rate, steps, power, schedule_map):
    """A DL4J learning-rate decay policy as a function of the step count.
    Policies: none|exponential|inverse|poly|sigmoid|step|schedule."""
    p = (policy or "none").lower()
    if p == "none":
        return lambda step: base_lr
    if p == "exponential":
        return lambda step: base_lr * decay_rate ** step
    if p == "inverse":
        return lambda step: base_lr / (1.0 + decay_rate * step) ** power
    if p == "poly":
        return lambda step: base_lr * (1.0 - min(step / float(steps), 1.0)) ** power
    if p == "sigmoid":
        return lambda step: base_lr / (1.0 + math.exp(decay_rate * (step - steps)))
    if p == "step":
        return lambda step: base_lr * decay_rate ** math.floor(step / float(steps))
    if p == "schedule":
        if not schedule_map:
            return lambda step: base_lr
        bounds = sorted(int(k) for k in schedule_map)
        rates = [float(schedule_map[k] if k in schedule_map else schedule_map[str(k)])
                 for k in bounds]

        def sched(step):
            lr = base_lr
            for b, r in zip(bounds, rates):
                if step >= b:
                    lr = r
            return lr

        return sched
    raise ValueError(f"Unknown lr policy '{policy}'")


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, on the host (a device scalar would
    cost a host-to-device copy per tensor per step)."""
    return float(np.float32(1) - np.float32(decay) ** count)


def _div_scalar(xs, b: float):
    """``[x / b for x in xs]`` with the rounding of ``x / b`` on the
    tensors' device: CUDA multiplies by ``float32(1) / float32(b)``."""
    if xs[0].is_cuda:
        return torch._foreach_mul(xs, float(np.float32(1) / np.float32(b)))
    return torch._foreach_div(xs, b)


def _axpy_slot(slot, decay: float, x, w: float):
    """``slot = w * x + decay * slot`` in place over lists (the moving
    averages; an IEEE sum does not depend on its operands' order)."""
    wx = torch._foreach_mul(x, w)
    torch._foreach_mul_(slot, decay)
    torch._foreach_add_(slot, wx)


@dataclasses.dataclass(frozen=True)
class Updater:
    """Base updater config: ``learning_rate`` plus an optional decay policy.
    Subclasses name their per-tensor state slots in ``_slots`` and write
    the direction of one step in ``_direction``."""

    learning_rate: float = 1e-3
    lr_policy: Optional[str] = None
    lr_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 2.0
    lr_schedule: Optional[dict] = None

    _slots = ()

    def lr(self, step: int) -> float:
        return _schedule(self.learning_rate, self.lr_policy, self.lr_decay_rate,
                         self.lr_policy_steps, self.lr_policy_power,
                         self.lr_schedule)(step)

    def _slot_init(self, slot: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def init_state(self, params: dict) -> dict:
        state = {"count": 0}
        for slot in self._slots:
            state[slot] = tree_map(lambda p, s=slot: self._slot_init(s, p), params)
        return state

    def _direction(self, g, slots: dict, count: int):
        """The step before the learning rate (optax's pre-scale update) and
        the new slot values for one tensor."""
        return g, slots

    def _foreach_direction(self, g: list, slots: list, count: int) -> list:
        """``_direction`` over lists of tensors (module docstring): the
        direction list, with ``slots`` (one list a slot, in ``_slots``
        order) updated in place."""
        return g

    def _step(self, g, slots: dict, count: int, lr: float):
        """(update tree, {slot: new tree}) for the (nested) gradients ``g``."""
        if isinstance(g, dict):
            steps = {k: self._step(x, {s: slots[s][k] for s in self._slots}, count, lr)
                     for k, x in g.items()}
            return ({k: u for k, (u, _) in steps.items()},
                    {s: {k: new[s] for k, (_, new) in steps.items()} for s in self._slots})
        d, new = self._direction(g, slots, count)
        return d * (-lr), new

    def update(self, grads: dict, state: dict):
        """One step: ``(updates, new_state)``; apply as ``p + u``. ``grads``
        may nest, as the parameters do."""
        count = state["count"]
        updates, slots = self._step(grads, {s: state[s] for s in self._slots},
                                    count + 1, self.lr(count))
        return updates, {"count": count + 1, **slots}

    def to_dict(self):
        d = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _UPDATER_REGISTRY[d.pop("@class").lower()]
        return cls(**d)


@register_updater
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    pass


@register_updater
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9
    momentum_schedule: Optional[dict] = None

    _slots = ("trace",)

    def _direction(self, g, slots, count):
        t = g + self.momentum * slots["trace"]
        return g + self.momentum * t, {"trace": t}

    def _foreach_direction(self, g, slots, count):
        (tr,) = slots
        torch._foreach_mul_(tr, self.momentum)
        torch._foreach_add_(tr, g)                       # t = g + m * t
        d = torch._foreach_mul(tr, self.momentum)
        torch._foreach_add_(d, g)                        # g + m * t
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    _slots = ("mu", "nu")

    def _moments(self, g, slots):
        mu = (1 - self.beta1) * g + self.beta1 * slots["mu"]
        nu = (1 - self.beta2) * (g * g) + self.beta2 * slots["nu"]
        return mu, nu

    def _mu_hat(self, g, mu, count):
        return mu / _bias_correction(self.beta1, count)

    def _direction(self, g, slots, count):
        mu, nu = self._moments(g, slots)
        nu_hat = nu / _bias_correction(self.beta2, count)
        d = self._mu_hat(g, mu, count) / (torch.sqrt(nu_hat) + self.epsilon)
        return d, {"mu": mu, "nu": nu}

    def _foreach_mu_hat(self, g, mu, count):
        return _div_scalar(mu, _bias_correction(self.beta1, count))

    def _foreach_direction(self, g, slots, count):
        mu, nu = slots
        _axpy_slot(mu, self.beta1, g, 1 - self.beta1)
        _axpy_slot(nu, self.beta2, torch._foreach_mul(g, g), 1 - self.beta2)
        den = _div_scalar(nu, _bias_correction(self.beta2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        d = self._foreach_mu_hat(g, mu, count)
        torch._foreach_div_(d, den)
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class AdaMax(Adam):
    def _direction(self, g, slots, count):
        mu = (1 - self.beta1) * g + self.beta1 * slots["mu"]
        nu = torch.maximum(torch.abs(g) + self.epsilon, self.beta2 * slots["nu"])
        return self._mu_hat(g, mu, count) / nu, {"mu": mu, "nu": nu}

    def _foreach_direction(self, g, slots, count):
        mu, nu = slots
        _axpy_slot(mu, self.beta1, g, 1 - self.beta1)
        a = torch._foreach_abs(g)
        torch._foreach_add_(a, self.epsilon)
        torch._foreach_mul_(nu, self.beta2)
        torch._foreach_maximum_(nu, a)                   # max(|g| + eps, b2 nu)
        d = self._foreach_mu_hat(g, mu, count)
        torch._foreach_div_(d, nu)
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class Nadam(Adam):
    def _mu_hat(self, g, mu, count):
        return (self.beta1 * (mu / _bias_correction(self.beta1, count + 1))
                + (1 - self.beta1) * (g / _bias_correction(self.beta1, count)))

    def _foreach_mu_hat(self, g, mu, count):
        d = _div_scalar(mu, _bias_correction(self.beta1, count + 1))
        torch._foreach_mul_(d, self.beta1)
        gb = _div_scalar(g, _bias_correction(self.beta1, count))
        torch._foreach_mul_(gb, 1 - self.beta1)
        torch._foreach_add_(d, gb)
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: float = 0.1
    epsilon: float = 1e-6

    _slots = ("sum_of_squares",)

    def _slot_init(self, slot, p):
        return torch.full_like(p, 0.1)  # optax's initial_accumulator_value

    def _direction(self, g, slots, count):
        s = g * g + slots["sum_of_squares"]
        inv = torch.where(s > 0, torch.rsqrt(s + self.epsilon),
                          torch.zeros((), dtype=s.dtype, device=s.device))
        return inv * g, {"sum_of_squares": s}

    def _foreach_direction(self, g, slots, count):
        (s,) = slots
        torch._foreach_add_(s, torch._foreach_mul(g, g))  # s = g * g + s
        d = torch._foreach_add(s, self.epsilon)
        torch._foreach_rsqrt_(d)
        zero = torch.zeros((), dtype=s[0].dtype, device=s[0].device)
        # torch.where has no foreach form: one where a member
        d = [torch.where(si > 0, di, zero) for si, di in zip(s, d)]
        torch._foreach_mul_(d, g)
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: float = 0.1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    _slots = ("nu",)

    def _direction(self, g, slots, count):
        nu = (1 - self.rms_decay) * (g * g) + self.rms_decay * slots["nu"]
        return torch.rsqrt(nu + self.epsilon) * g, {"nu": nu}

    def _foreach_direction(self, g, slots, count):
        (nu,) = slots
        _axpy_slot(nu, self.rms_decay, torch._foreach_mul(g, g), 1 - self.rms_decay)
        d = torch._foreach_add(nu, self.epsilon)
        torch._foreach_rsqrt_(d)
        torch._foreach_mul_(d, g)
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    _slots = ("e_g", "e_x")

    def lr(self, step):
        # DL4J's AdaDelta applies the raw delta as a descent step
        return 1.0

    def _direction(self, g, slots, count):
        e_g = (1 - self.rho) * (g * g) + self.rho * slots["e_g"]
        d = torch.sqrt(slots["e_x"] + self.epsilon) / torch.sqrt(e_g + self.epsilon) * g
        e_x = (1 - self.rho) * (d * d) + self.rho * slots["e_x"]
        return d, {"e_g": e_g, "e_x": e_x}

    def _foreach_direction(self, g, slots, count):
        e_g, e_x = slots
        _axpy_slot(e_g, self.rho, torch._foreach_mul(g, g), 1 - self.rho)
        d = torch._foreach_add(e_x, self.epsilon)
        torch._foreach_sqrt_(d)
        den = torch._foreach_add(e_g, self.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(d, den)
        torch._foreach_mul_(d, g)                        # sqrt(ex+eps)/sqrt(eg+eps)*g
        _axpy_slot(e_x, self.rho, torch._foreach_mul(d, d), 1 - self.rho)
        return d


@register_updater
@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen params."""

    def _direction(self, g, slots, count):
        return torch.zeros_like(g), slots

    def _foreach_direction(self, g, slots, count):
        return [torch.zeros_like(x) for x in g]


def gradient_normalization(kind: Optional[str], threshold: float = 1.0):
    """Per-layer gradient normalization (reference GradientNormalization
    enum). Returns a function ``grads tree -> grads tree`` for one layer;
    "per layer" norms run over every leaf of the (nested) tree, "per param
    type" ones leaf by leaf."""
    if not kind or str(kind).lower() == "none":
        return lambda g: g
    k = str(kind).lower()

    def l2(g):
        return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(g)) + 1e-12)

    def leaf_l2(x):
        return torch.sqrt(torch.sum(x * x) + 1e-12)

    if k == "renormalizel2perlayer":
        def f(g):
            n = l2(g)
            return tree_map(lambda x: x / n, g)
        return f
    if k == "renormalizel2perparamtype":
        return lambda g: tree_map(lambda x: x / leaf_l2(x), g)
    if k == "clipelementwiseabsolutevalue":
        return lambda g: tree_map(lambda x: x.clamp(-threshold, threshold), g)
    if k == "clipl2perlayer":
        def f(g):
            scale = torch.clamp_max(threshold / l2(g), 1.0)
            return tree_map(lambda x: x * scale, g)
        return f
    if k == "clipl2perparamtype":
        return lambda g: tree_map(
            lambda x: x * torch.clamp_max(threshold / leaf_l2(x), 1.0), g)
    raise ValueError(f"Unknown gradient normalization '{kind}'")
