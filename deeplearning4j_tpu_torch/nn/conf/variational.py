"""Variational autoencoder layer (counterpart of
``deeplearning4j_tpu/nn/conf/variational.py``).

Parameters are the JAX package's flat dict: the encoder stack ``e{i}W`` /
``e{i}b``, the decoder stack ``d{i}W`` / ``d{i}b``, the q(z|x) heads
``pzxMeanW/b`` and ``pzxLogStd2W/b``, and the reconstruction head
``pxzW/b`` (n_in wide for Bernoulli, 2 * n_in for Gaussian: mean, then
log-variance). In a supervised stack the layer's output is the mean of
q(z|x). ``pretrain_loss`` is the negative ELBO with reparameterised
samples; its standard normals come from ``draw_pretrain`` (one (batch,
n_out) draw a sample) unless given as ``draws``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.initializers import init_weights


def _dense(layer, gen, a, b, device, params, name):
    params[name + "W"] = init_weights(gen, (a, b), a, b, layer.weight_init, layer.dist, device)
    params[name + "b"] = torch.full((b,), float(layer.bias_init), device=device)


def _mlp_apply(params, x, n, act, prefix):
    for i in range(n):
        x = act(x @ params[f"{prefix}{i}W"] + params[f"{prefix}{i}b"])
    return x


def _bernoulli_logp(p, x):
    """log p(x | logits p), summed over features (sigmoid + binary CE)."""
    return -torch.sum(torch.clamp_min(p, 0) - p * x + torch.log1p(torch.exp(-torch.abs(p))), -1)


def _gaussian_logp(p, x):
    mu, lv = torch.chunk(p, 2, dim=-1)
    return -0.5 * torch.sum(lv + (x - mu) ** 2 / torch.exp(lv) + math.log(2 * math.pi), -1)


@register_layer
@dataclasses.dataclass(frozen=True)
class VariationalAutoencoder(BaseLayer):
    """VAE as a layer. ``reconstruction``: 'bernoulli' or 'gaussian';
    ``pzx_activation`` acts on the q(z|x) mean and log-variance;
    ``activation`` on the encoder and decoder hidden layers."""

    n_in: Optional[int] = None
    n_out: int = 0                       # latent size
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    pzx_activation: str = "identity"
    reconstruction: str = "bernoulli"
    num_samples: int = 1
    activation: str = "tanh"

    def input_kind(self):
        return "ff"

    def is_pretrainable(self):
        return True

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, device):
        n_in = self.n_in or input_type.flat_size()
        enc = (n_in,) + tuple(self.encoder_layer_sizes)
        dec = (self.n_out,) + tuple(self.decoder_layer_sizes)
        params = {}
        for prefix, sizes in (("e", enc), ("d", dec)):
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
                _dense(self, gen, a, b, device, params, f"{prefix}{i}")
        recon_out = n_in if self.reconstruction == "bernoulli" else 2 * n_in
        for name, (a, b) in (("pzxMean", (enc[-1], self.n_out)),
                             ("pzxLogStd2", (enc[-1], self.n_out)),
                             ("pxz", (dec[-1], recon_out))):
            _dense(self, gen, a, b, device, params, name)
        return params, {}

    def regularizable(self):
        return tuple([f"e{i}W" for i in range(len(self.encoder_layer_sizes))]
                     + [f"d{i}W" for i in range(len(self.decoder_layer_sizes))]
                     + ["pzxMeanW", "pzxLogStd2W", "pxzW"])

    def _encode(self, params, x):
        h = _mlp_apply(params, x, len(self.encoder_layer_sizes),
                       get_activation(self.activation), "e")
        pzx_act = get_activation(self.pzx_activation)
        return (pzx_act(h @ params["pzxMeanW"] + params["pzxMeanb"]),
                pzx_act(h @ params["pzxLogStd2W"] + params["pzxLogStd2b"]))

    def _decode(self, params, z):
        h = _mlp_apply(params, z, len(self.decoder_layer_sizes),
                       get_activation(self.activation), "d")
        return h @ params["pxzW"] + params["pxzb"]

    def _logp(self, p, x):
        if self.reconstruction == "bernoulli":
            return _bernoulli_logp(p, x)
        if self.reconstruction == "gaussian":
            return _gaussian_logp(p, x)
        raise ValueError(self.reconstruction)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        """Supervised forward: the mean of q(z|x)."""
        return self._encode(params, x)[0], state

    def draw_pretrain(self, x, rng: torch.Generator, num_samples: Optional[int] = None):
        """One (batch, n_out) standard normal a sample."""
        n = self.num_samples if num_samples is None else num_samples
        return [torch.randn((x.shape[0], self.n_out), generator=rng, device=x.device,
                            dtype=x.dtype) for _ in range(n)]

    def _samples(self, params, x, mean, logvar, eps_list):
        for eps in eps_list:
            yield self._logp(self._decode(params, mean + torch.exp(0.5 * logvar) * eps), x)

    def pretrain_loss(self, params, state, x, rng=None, draws=None):
        """Negative ELBO averaged over the minibatch: E_q[-log p(x|z)] over
        ``num_samples`` draws, plus KL(q(z|x) || N(0, I)) in closed form."""
        if draws is None:
            draws = self.draw_pretrain(x, rng)
        mean, logvar = self._encode(params, x)
        kl = -0.5 * torch.sum(1.0 + logvar - mean ** 2 - torch.exp(logvar), -1)
        recon = 0.0
        for logp in self._samples(params, x, mean, logvar, draws):
            recon = recon - logp
        return torch.mean(recon / self.num_samples + kl)

    def reconstruction_probability(self, params, x, rng=None, num_samples: int = 5,
                                   draws=None):
        """Monte-Carlo estimate of log p(x) (reference
        reconstructionLogProbability)."""
        if draws is None:
            draws = self.draw_pretrain(x, rng, num_samples)
        mean, logvar = self._encode(params, x)
        total = None
        for logp in self._samples(params, x, mean, logvar, draws):
            total = logp if total is None else torch.logaddexp(total, logp)
        return total - math.log(float(len(draws)))

    def generate_at_mean_given_z(self, params, z):
        """The decoder's mean for a latent (reference generateAtMeanGivenZ)."""
        p = self._decode(params, z)
        if self.reconstruction == "bernoulli":
            return torch.sigmoid(p)
        return torch.chunk(p, 2, dim=-1)[0]
