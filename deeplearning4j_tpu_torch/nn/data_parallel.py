"""The data-parallel group a training step runs in, and the collectives
the step takes over it.

Under the JAX package's mesh a step sees the *global* batch: GSPMD turns
the gradient of a loss over a batch sharded on ``data`` into an
all-reduce, and a batch-norm layer's ``jnp.mean`` over that batch into a
cross-device reduction. In the port each rank of a ``torch.distributed``
group holds its own rows, so the step does both by hand inside
:func:`data_group`, which ``parallel/trainer.py`` enters around each
step:

- :func:`mean_gradients`: every trainable gradient leaf and the loss that
  becomes ``score()`` averaged over the ranks, one flat bucket a dtype
  (one collective a dtype, not one a leaf; the float32 loss rides in the
  float32 bucket);
- :func:`global_batch_stats`: a batch-norm layer's per-channel mean and
  biased variance over the global batch (SyncBatchNorm's algebra, the
  JAX package's numerics: two passes for float32, the single float32 pass
  of sum and sum of squares for bf16/f16), through an all-reduce that
  autograd differentiates (its backward all-reduces the incoming
  gradient, so each rank's gradient carries every rank's share of the
  statistics' derivative);
- :func:`all_reduce_sums`: the two per-channel sums the fused block's
  backward takes over the batch (Σdy and Σdy·x̂), with the row count.

The mean over ranks of each rank's mean loss is the mean over the global
batch because shards are equal (``ClusterTrainer`` checks it at each
epoch's first batch). A regularization term enters each rank's gradient
once, and the mean keeps it once. With no process group nothing here
runs. A group of one rank still all-reduces the gradients and the loss
(a sum over one rank, divided by 1.0: the same bits) and takes its
statistics locally, so its step is the single-process one, bitwise.
:data:`all_reduces` counts the collectives launched.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["data_group", "world", "reducing", "mean_gradients", "global_batch_stats",
           "all_reduce_sums", "all_reduces"]

_ACTIVE = {"group": None, "world": 1, "reduce": False}

#: all-reduces launched by this module (a caller may reset it)
all_reduces = 0


def world() -> int:
    """Ranks of the active data group (1 when none is active)."""
    return _ACTIVE["world"]


def reducing() -> bool:
    """Whether the step averages its gradients over a process group (one
    is initialised and a data group entered, of any size)."""
    return _ACTIVE["reduce"]


@contextlib.contextmanager
def data_group(group=None, size: Optional[int] = None):
    """Make ``group`` (a ``torch.distributed`` process group, None for the
    default one) the data group of the steps run inside, of ``size`` ranks
    (the group's size by default). With no process group initialised the
    step stays single-process; statistics go global above one rank. The
    setting is process-wide, not per thread: a watchdog runs the step on
    a worker thread."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    if size is None:
        size = dist.get_world_size(group) if up else 1
    saved = dict(_ACTIVE)
    _ACTIVE.update(group=group, world=int(size), reduce=up)
    try:
        yield
    finally:
        _ACTIVE.update(saved)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    global all_reduces
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_ACTIVE["group"])
    all_reduces += 1
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over
    the ranks as well (d(Σ_r s_r)/ds_r = 1, and every rank's loss reads
    the sum)."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


def _row_count(x: torch.Tensor) -> torch.Tensor:
    return torch.full((1,), float(x.numel() // x.shape[-1]), dtype=torch.float32,
                      device=x.device)


def global_batch_stats(x: torch.Tensor):
    """Per-channel (mean, biased var) over all but the last axis of the
    global batch; see the module docstring."""
    axes = tuple(range(x.dim() - 1))
    c = x.shape[-1]
    if x.dtype in (torch.bfloat16, torch.float16):
        xf = x.float()
        tot = _AllReduceSum.apply(torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                                             _row_count(x)]))
        n = tot[2 * c]
        mean = tot[:c] / n
        return mean, torch.clamp_min(tot[c:2 * c] / n - mean * mean, 0.0)
    s = _AllReduceSum.apply(torch.cat([x.sum(dim=axes), _row_count(x).to(x.dtype)]))
    n = s[c]
    mean = s[:c] / n
    d = x - mean
    var = _AllReduceSum.apply((d * d).sum(dim=axes)) / n
    return mean, var


def all_reduce_sums(*sums: torch.Tensor, rows: int):
    """The per-channel ``sums`` summed over the ranks, and the global row
    count (``rows`` on this rank), in one collective. Not differentiated."""
    dt = sums[0].dtype
    flat = torch.cat([s.reshape(-1).to(dt) for s in sums]
                     + [torch.full((1,), float(rows), dtype=dt, device=sums[0].device)])
    flat = _all_reduce(flat)
    out, off = [], 0
    for s in sums:
        out.append(flat[off:off + s.numel()].view(s.shape))
        off += s.numel()
    return (*out, flat[off])


def mean_gradients(leaves, loss: torch.Tensor) -> torch.Tensor:
    """Average the gradient tensors ``leaves`` over the ranks in place and
    return the loss averaged too: one flat bucket a dtype, one all-reduce
    a bucket, the loss the last element of its dtype's bucket."""
    by_dtype = {}
    for g in leaves:
        by_dtype.setdefault(g.dtype, []).append(g)
    loss = loss.detach().reshape(1)
    by_dtype.setdefault(loss.dtype, [])
    n = float(world())
    out = loss
    with torch.no_grad():
        for dtype, group in by_dtype.items():
            parts = [g.reshape(-1) for g in group]
            if dtype == loss.dtype:
                parts.append(loss)
            flat = _all_reduce(torch.cat(parts))
            flat.div_(n)
            off = 0
            for g in group:
                g.copy_(flat[off:off + g.numel()].view(g.shape))
                off += g.numel()
            if dtype == loss.dtype:
                out = flat[off:off + 1]
    return out.reshape(())
