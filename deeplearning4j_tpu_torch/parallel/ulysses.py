"""All-to-all (Ulysses-style) sequence parallelism (counterpart of
``deeplearning4j_tpu/parallel/ulysses.py``; DeepSpeed-Ulysses).

The sequence is sharded over the ranks of one mesh axis, one process a
rank. One all-to-all re-shards each of q, k and v from time blocks to head
groups, so that every rank runs full-sequence ``reference_attention`` for
``heads / n`` heads, and a second all-to-all restores the time blocks.
Both all-to-alls are ``dist.all_to_all_single`` inside an
``autograd.Function`` whose backward is the same all-to-all of the
gradient (a permutation's transpose). The softmax is exact (no online
accumulation). Trade-offs against ``ring_self_attention``: two
all-to-alls of activation size against n - 1 K/V exchanges, and
``O(t^2 h/n)`` scores a rank against the ring's ``O(t_local^2 h)``.
Needs heads divisible by the axis size. At one rank no collective runs.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel.ring_attention import axis_group, reference_attention

__all__ = ["ulysses_self_attention"]


def _all_to_all(x, group):
    """Chunk j of x's first axis to rank j of ``group``, chunk j of the
    result from rank j."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _scatter_heads(x, group, n):
    """(b, h, t/n, d) time block -> (b, h/n, t, d) head group."""
    b, h, t_l, d = x.shape
    parts = x.reshape(b, n, h // n, t_l, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(parts, group)  # got[j]: rank j's time block of my heads
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t_l, d)


def _gather_heads(x, group, n):
    """(b, h/n, t, d) head group -> (b, h, t/n, d) time block."""
    b, hn, t, d = x.shape
    parts = x.reshape(b, hn, n, t // n, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(parts, group)  # got[j]: rank j's heads of my time block
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hn, t // n, d)


def ulysses_self_attention(q, k, v, mesh=None, axis_name: str = "data",
                           causal: bool = False):
    """Sequence-parallel attention through head/sequence all-to-alls over
    ``axis_name`` of ``mesh`` (every rank of the default group when
    ``mesh`` is None): q, k, v are this rank's ``(batch, heads, t_local,
    head_dim)`` time blocks, in rank order along the axis; returns this
    rank's block of the output. Numerically ``reference_attention`` on the
    gathered sequence; differentiable. heads must divide by the axis size."""
    group, n, _ = axis_group(mesh, axis_name)
    if q.shape[1] % n != 0:
        raise ValueError(
            f"Ulysses needs heads ({q.shape[1]}) divisible by the "
            f"'{axis_name}' axis size ({n}); use ring_self_attention for "
            "head counts below the mesh size")
    if n == 1:
        return reference_attention(q, k, v, causal=causal)
    qh, kh, vh = (_scatter_heads(x, group, n) for x in (q, k, v))
    return _gather_heads(reference_attention(qh, kh, vh, causal=causal), group, n)
