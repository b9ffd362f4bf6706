"""Attention on one device and sequence-parallel ring attention
(counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``:
``reference_attention``, ``flash_self_attention`` and
``ring_self_attention``).

Shapes are the JAX package's: q, k, v are ``(batch, heads, time,
head_dim)``. ``reference_attention`` is the dense attention, and the plain
PyTorch version of the flash kernel (``perf/kernels/flash_attention.py``).
``flash_self_attention`` goes through that kernel's wrapper: the kernels on a
CUDA tensor, the plain versions on a CPU tensor, as the JAX package takes its
dense path off the TPU. It is differentiable, as the JAX entry is through the
library's ``custom_vjp``: with grad on, the wrapper's
``torch.autograd.Function`` saves the rows' log-sum-exp and its backward runs
the dK/dV and dQ kernels.

``ring_self_attention`` shards the time axis over the ranks of one mesh
axis, one process a rank: each rank passes its own time block of q, k and
v (the blocks in rank order along the axis) and gets its block of the
output. K/V blocks rotate around the ring (``dist.batch_isend_irecv``,
rank r sending to r + 1) through an ``autograd.Function`` whose backward
runs the reverse ring, as the JAX package's ``lax.ppermute`` transposes;
the softmax is accumulated online (the JAX ``_ring_block``, its ``-inf`` /
NaN guards and ``1e-30`` floor), so no rank holds more than its
``(t_local, t_local)`` scores. At one rank the ring exchanges nothing.
The body is plain torch, as the JAX body is plain ``jnp``: no kernel.
"""

from __future__ import annotations

import torch

__all__ = ["reference_attention", "flash_self_attention", "ring_self_attention",
           "axis_group"]


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


def axis_group(mesh, axis_name: str):
    """``(group, size, index)`` of this rank along ``axis_name`` of
    ``mesh`` (the default group's ranks when ``mesh`` is None): the
    ``torch.distributed`` group (None for the default one), its size and
    this rank's place in it. ``(None, 1, 0)`` with no process group or an
    axis of one rank."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0
    if mesh is None:
        return None, dist.get_world_size(), dist.get_rank()
    from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    if axis_name not in (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"mesh axis {axis_name!r}: a mesh has the axes "
                         f"'{DATA_AXIS}' and '{MODEL_AXIS}'")
    size = mesh.shape[axis_name]
    if size == 1:
        return None, 1, 0
    group = mesh.data_group if axis_name == DATA_AXIS else mesh.model_group
    return group, size, dist.get_rank(group)


class _RingShift(torch.autograd.Function):
    """This rank's tensor to the next rank of the group, the previous
    rank's tensor back; the backward sends the incoming gradient the other
    way round (the transpose of the permutation)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.ring = (group, size, index)
        return _shift(x, group, size, index, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.ring, -1), None, None, None


def _shift(x, group, size, index, step):
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)

    def peer(i):
        return i if group is None else dist.get_global_rank(group, i)

    ops = [dist.P2POp(dist.isend, x, peer((index + step) % size), group),
           dist.P2POp(dist.irecv, out, peer((index - step) % size), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ring_block(q, k, v, group, size, index, causal):
    """The JAX ``_ring_block`` on this rank's local time blocks."""
    t_local, d = q.shape[2], q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=q.device)).to(q.dtype)
    q_pos = index * t_local + torch.arange(t_local, device=q.device)
    ninf = torch.tensor(float("-inf"), dtype=q.dtype, device=q.device)
    num = torch.zeros_like(q)
    denom = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    maxv = torch.full(q.shape[:-1], float("-inf"), dtype=q.dtype, device=q.device)
    k_cur, v_cur = k, v
    for i in range(size):
        src = (index - i) % size  # whose K/V block this is
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k_cur) * scale
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, ninf)
        new_max = torch.maximum(maxv, scores.amax(dim=-1))
        # a fully masked row so far: exp(-inf - -inf) would be NaN
        both_inf = torch.isinf(maxv) & torch.isinf(new_max)
        correction = torch.exp(torch.where(both_inf, torch.zeros_like(maxv), maxv - new_max))
        p = torch.exp(torch.where(torch.isinf(scores), ninf, scores - new_max[..., None]))
        p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
        num = num * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_cur)
        denom = denom * correction + p.sum(dim=-1)
        maxv = new_max
        if i + 1 < size:
            k_cur = _RingShift.apply(k_cur, group, size, index)
            v_cur = _RingShift.apply(v_cur, group, size, index)
    return num / torch.clamp_min(denom[..., None], 1e-30)


def ring_self_attention(q, k, v, mesh=None, axis_name: str = "data", causal: bool = False):
    """Sequence-parallel attention over ``axis_name`` of ``mesh`` (every
    rank of the default group when ``mesh`` is None): q, k, v are this
    rank's ``(batch, heads, t_local, head_dim)`` time blocks, the blocks in
    rank order along the axis; returns this rank's block of the output.
    Equal, up to float tolerance, to ``reference_attention`` on the
    gathered sequence; differentiable (the backward runs the reverse ring).
    Every rank of the axis must call it with blocks of one shape."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"ring_self_attention takes q, k, v of one (batch, heads, "
                         f"t_local, head_dim) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    group, size, index = axis_group(mesh, axis_name)
    return _ring_block(q, k, v, group, size, index, causal)
