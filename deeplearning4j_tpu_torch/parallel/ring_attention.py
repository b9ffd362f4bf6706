"""Single-device attention (counterpart of
``deeplearning4j_tpu/parallel/ring_attention.py``: ``reference_attention``
and ``flash_self_attention``).

Shapes are the JAX package's: q, k, v are ``(batch, heads, time,
head_dim)``. ``reference_attention`` is the dense attention, and the plain
PyTorch version of the flash kernel (``perf/kernels/flash_attention.py``).
``flash_self_attention`` goes through that kernel's wrapper: the kernels on a
CUDA tensor, the plain versions on a CPU tensor, as the JAX package takes its
dense path off the TPU. It is differentiable, as the JAX entry is through the
library's ``custom_vjp``: with grad on, the wrapper's
``torch.autograd.Function`` saves the rows' log-sum-exp and its backward runs
the dK/dV and dQ kernels. The sequence-parallel ``ring_self_attention`` (a
mesh of devices) is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["reference_attention", "flash_self_attention"]


def reference_attention(q, k, v, causal: bool = False, key_mask=None):
    """Plain full-matrix attention. ``key_mask`` (batch, time) zeros out
    padded keys. Scores are divided by ``sqrt(d)`` in q's dtype; masked
    entries get ``-0.7 * finfo(dtype).max``, a large finite negative rather
    than -inf, so a fully masked row softmaxes to uniform finite weights
    instead of NaN."""
    root = torch.tensor(float(q.shape[-1]), device=q.device).sqrt().to(q.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / root
    neg = torch.tensor(-0.7 * torch.finfo(scores.dtype).max, dtype=scores.dtype,
                       device=scores.device)
    if causal:
        t_q, t_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=scores.device).tril()
        scores = torch.where(mask, scores, neg)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :].bool(), scores, neg)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def flash_self_attention(q, k, v, causal: bool = False):
    """Attention through the hand-written flash kernels on a CUDA tensor
    (tiled online softmax; the (t, t) score matrix is never stored), their
    plain versions on a CPU tensor; differentiable. No key mask: padded
    batches take ``reference_attention``. The kernels read head-split views
    in place (any strides but a contiguous last axis) and write the outputs
    in the inputs' layouts. float64, which no kernel takes, runs only on the
    CPU, where it takes :func:`reference_attention` and its autograd (a
    float64 network is a referee for the float32 one)."""
    if q.dtype == torch.float64 and q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal)
    from deeplearning4j_tpu_torch.perf.kernels import flash_attention
    return flash_attention.flash_attention(q, k, v, causal=causal)
