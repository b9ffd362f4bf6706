"""Layerwise-pretrainable feed-forward layers: the denoising ``AutoEncoder``
and the ``RBM`` (counterpart of ``deeplearning4j_tpu/nn/conf/pretrain.py``).

``MultiLayerNetwork.pretrain`` drives them: it featurizes the input through
the layers below and minimises the layer's ``pretrain_loss`` with the
layer's updater. The RBM's loss is the free-energy difference
``mean F(v0) - mean F(vk)``, ``vk`` the detached end of a k-step Gibbs
chain, whose gradient is the CD-k update.

Random draws are split from the math, as in ``regularization.py``:
``draw_pretrain`` takes from a ``torch.Generator`` the uniforms (for a
Bernoulli sample ``u < p``, as ``jax.random.bernoulli`` is
``uniform < p``) and standard normals the loss needs, and
``pretrain_loss(..., draws=)`` takes them given, which the parity tests do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.initializers import init_weights


def _tied_init(layer, gen, input_type, device) -> dict:
    """W (n_in, n_out), hidden bias b, visible bias vb."""
    n_in = layer.n_in or input_type.flat_size()
    return {"W": init_weights(gen, (n_in, layer.n_out), n_in, layer.n_out,
                              layer.weight_init, layer.dist, device),
            "b": torch.full((layer.n_out,), float(layer.bias_init), device=device),
            "vb": torch.full((n_in,), float(layer.bias_init), device=device)}


def _kl_sparsity(rho: float, rho_hat):
    """KL(rho || rho_hat) summed over units."""
    return torch.sum(rho * torch.log(rho / rho_hat)
                     + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat)))


@register_layer
@dataclasses.dataclass(frozen=True)
class AutoEncoder(BaseLayer):
    """Denoising autoencoder with tied weights: the supervised forward is
    ``encode(x)``; pretraining reconstructs the clean input from a copy
    whose units are zeroed with probability ``corruption_level``. ``loss``:
    'mse' or 'xent' (binary cross-entropy, for sigmoid and [0, 1] data)."""

    n_in: Optional[int] = None
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"
    activation: str = "sigmoid"

    def input_kind(self):
        return "ff"

    def is_pretrainable(self):
        return True

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, device):
        return _tied_init(self, gen, input_type, device), {}

    def encode(self, params, x):
        return get_activation(self.activation)(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return get_activation(self.activation)(h @ params["W"].T + params["vb"])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.encode(params, x), state

    def draw_pretrain(self, x, rng: torch.Generator):
        """The corruption's uniforms (x's shape), or None without one."""
        if self.corruption_level <= 0:
            return None
        return torch.rand(x.shape, generator=rng, device=x.device)

    def pretrain_loss(self, params, state, x, rng=None, draws=None):
        if draws is None and rng is not None:
            draws = self.draw_pretrain(x, rng)
        x_in = x
        if self.corruption_level > 0 and draws is not None:
            x_in = torch.where(draws < 1.0 - self.corruption_level, x,
                               torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)
        h = self.encode(params, x_in)
        z = self.decode(params, h)
        if self.loss == "mse":
            recon = torch.mean(torch.sum((z - x) ** 2, -1))
        elif self.loss == "xent":
            eps = 1e-7
            recon = torch.mean(-torch.sum(x * torch.log(z + eps)
                                          + (1 - x) * torch.log(1 - z + eps), -1))
        else:
            raise ValueError(self.loss)
        if self.sparsity > 0:
            recon = recon + _kl_sparsity(self.sparsity,
                                         torch.clamp(torch.mean(h, 0), 1e-6, 1 - 1e-6))
        return recon


@register_layer
@dataclasses.dataclass(frozen=True)
class RBM(BaseLayer):
    """Restricted Boltzmann machine, trained by CD-k through the
    free-energy difference. Units: binary on both sides, or
    ``visible_unit='gaussian'`` (identity mean, unit variance). The
    supervised forward is ``activation(x W + b)``."""

    n_in: Optional[int] = None
    n_out: int = 0
    k: int = 1
    visible_unit: str = "binary"   # binary | gaussian
    hidden_unit: str = "binary"
    sparsity: float = 0.0
    activation: str = "sigmoid"

    def input_kind(self):
        return "ff"

    def is_pretrainable(self):
        return True

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, device):
        return _tied_init(self, gen, input_type, device), {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return get_activation(self.activation)(x @ params["W"] + params["b"]), state

    def free_energy(self, params, v):
        """F(v) = -v.vb - sum_j softplus(v W_j + b_j), plus v^2 / 2 for
        Gaussian visible units."""
        f = -v @ params["vb"] - torch.sum(F.softplus(v @ params["W"] + params["b"]), -1)
        if self.visible_unit == "gaussian":
            f = f + 0.5 * torch.sum(v * v, -1)
        return f

    def draw_chain(self, x, rng: torch.Generator, k: Optional[int] = None) -> list:
        """The Gibbs chain's draws, one (hidden uniforms, visible uniforms
        or normals) pair a step."""
        k = self.k if k is None else k
        b, n_in = x.shape
        out = []
        for _ in range(k):
            u_h = torch.rand((b, self.n_out), generator=rng, device=x.device)
            if self.visible_unit == "gaussian":
                r_v = torch.randn((b, n_in), generator=rng, device=x.device, dtype=x.dtype)
            else:
                r_v = torch.rand((b, n_in), generator=rng, device=x.device)
            out.append((u_h, r_v))
        return out

    draw_pretrain = draw_chain

    def gibbs_chain(self, params, v0, rng=None, k=None, draws=None):
        """k alternating Gibbs steps from v0; the last visible mean
        (probabilities, or the Gaussian mean)."""
        if draws is None:
            draws = self.draw_chain(v0, rng, k)
        v, v_mean = v0, v0
        for u_h, r_v in draws:
            p_h = torch.sigmoid(v @ params["W"] + params["b"])
            h = (u_h < p_h).to(v.dtype)
            pre = h @ params["W"].T + params["vb"]
            if self.visible_unit == "gaussian":
                v, v_mean = pre + r_v, pre
            else:
                v_mean = torch.sigmoid(pre)
                v = (r_v < v_mean).to(h.dtype)
        return v_mean

    def pretrain_loss(self, params, state, x, rng=None, draws=None):
        with torch.no_grad():
            vk = self.gibbs_chain({k: p.detach() for k, p in params.items()}, x.detach(),
                                  rng, draws=draws)
        loss = torch.mean(self.free_energy(params, x)) - torch.mean(self.free_energy(params, vk))
        if self.sparsity > 0:
            rho_hat = torch.clamp(torch.mean(torch.sigmoid(x @ params["W"] + params["b"]), 0),
                                  1e-6, 1 - 1e-6)
            loss = loss + _kl_sparsity(self.sparsity, rho_hat)
        return loss

    def reconstruction_error(self, params, x, rng=None, draws=None):
        """Mean squared error after one Gibbs step."""
        vk = self.gibbs_chain(params, x, rng, k=1, draws=draws)
        return torch.mean(torch.sum((vk - x) ** 2, -1))
