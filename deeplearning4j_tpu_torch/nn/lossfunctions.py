"""Loss functions (counterpart of ``deeplearning4j_tpu/nn/lossfunctions.py``).

Losses are computed from the *pre-activation* output plus the activation
name, so softmax+MCXENT goes through ``log_softmax`` and sigmoid+XENT
through ``softplus``; the backward pass is autograd.

- ``labels``/``preout`` are (batch, n_out) or (batch, time, n_out).
- ``mask`` is optional (batch,) or (batch, time); masked scores are
  excluded from the mean.
- ``weights`` is an optional per-output weight vector.
- Each loss returns the per-element score array; :func:`score` reduces it
  the way DL4J's computeScore does: sum over outputs, mean over counted
  examples/timesteps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation

_EPS = 1e-7


def _apply_act(preout, activation):
    return get_activation(activation)(preout)


def _weighted(arr, weights):
    if weights is None:
        return arr
    return arr * torch.as_tensor(weights, dtype=arr.dtype, device=arr.device)


def _score_mse(labels, preout, activation, weights):
    d = _apply_act(preout, activation) - labels
    return _weighted(d * d, weights)


def _score_l1(labels, preout, activation, weights):
    return _weighted(torch.abs(_apply_act(preout, activation) - labels), weights)


def _score_mcxent(labels, preout, activation, weights):
    if str(activation).lower() == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(_apply_act(preout, activation).clamp(_EPS, 1.0 - _EPS))
    return _weighted(-labels * logp, weights)


def _score_xent(labels, preout, activation, weights):
    # binary cross-entropy, stable for a sigmoid activation:
    # log(sigmoid(x)) = -softplus(-x); log(1 - sigmoid(x)) = -softplus(x)
    if str(activation).lower() == "sigmoid":
        s = -(labels * -F.softplus(-preout)
              + (1.0 - labels) * -F.softplus(preout))
    else:
        out = _apply_act(preout, activation).clamp(_EPS, 1.0 - _EPS)
        s = -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))
    return _weighted(s, weights)


def _score_kld(labels, preout, activation, weights):
    out = _apply_act(preout, activation).clamp(_EPS, 1.0)
    lab = labels.clamp(_EPS, 1.0)
    return _weighted(labels * (torch.log(lab) - torch.log(out)), weights)


def _score_poisson(labels, preout, activation, weights):
    out = _apply_act(preout, activation).clamp_min(_EPS)
    return _weighted(out - labels * torch.log(out), weights)


def _score_cosine(labels, preout, activation, weights):
    out = _apply_act(preout, activation)
    dot = torch.sum(out * labels, dim=-1, keepdim=True)
    no = torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(_EPS)
    nl = torch.linalg.vector_norm(labels, dim=-1, keepdim=True).clamp_min(_EPS)
    sim = dot / (no * nl)
    # per-example score spread across one row (the sum over outputs
    # reduces it back)
    return _weighted(((1.0 - sim) / labels.shape[-1]).expand(labels.shape),
                     weights)


def _score_hinge(labels, preout, activation, weights):
    y = torch.where(labels > 0, 1.0, -1.0).to(preout.dtype)
    out = _apply_act(preout, activation)
    return _weighted(torch.clamp_min(1.0 - y * out, 0.0), weights)


def _score_squared_hinge(labels, preout, activation, weights):
    h = _score_hinge(labels, preout, activation, None)
    return _weighted(h * h, weights)


def _score_mape(labels, preout, activation, weights):
    out = _apply_act(preout, activation)
    return _weighted(100.0 * torch.abs((labels - out)
                                       / torch.abs(labels).clamp_min(_EPS)),
                     weights)


def _score_msle(labels, preout, activation, weights):
    out = _apply_act(preout, activation)
    d = (torch.log1p(out.clamp_min(-1 + _EPS))
         - torch.log1p(labels.clamp_min(-1 + _EPS)))
    return _weighted(d * d, weights)


LOSSES = {
    "mse": _score_mse,
    "l2": _score_mse,
    "l1": _score_l1,
    "mae": _score_l1,
    "mcxent": _score_mcxent,
    "xent": _score_xent,
    "negativeloglikelihood": _score_mcxent,
    "nll": _score_mcxent,
    "kl_divergence": _score_kld,
    "kld": _score_kld,
    "reconstruction_crossentropy": _score_xent,
    "poisson": _score_poisson,
    "cosine_proximity": _score_cosine,
    "hinge": _score_hinge,
    "squared_hinge": _score_squared_hinge,
    "mean_absolute_percentage_error": _score_mape,
    "mape": _score_mape,
    "mean_squared_logarithmic_error": _score_msle,
    "msle": _score_msle,
}


def get_loss(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]


def score_array(loss, labels, preout, activation="identity", mask=None,
                weights=None):
    """Per-example score: sum over the output dim, masked. Shape (batch,)
    or (batch, time)."""
    s = get_loss(loss)(labels, preout, activation, weights).sum(dim=-1)
    if mask is not None:
        s = s * mask
    return s


def score(loss, labels, preout, activation="identity", mask=None,
          weights=None):
    """Scalar score: the sum of per-example scores over the number of
    counted examples (mask-aware)."""
    s = score_array(loss, labels, preout, activation, mask, weights)
    if mask is not None:
        return s.sum() / torch.clamp_min(mask.sum(), 1.0)
    return s.sum() / s.numel()
