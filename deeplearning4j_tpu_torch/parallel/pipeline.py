"""Pipeline parallelism, GPipe-style microbatch pipelining (counterpart of
``deeplearning4j_tpu/parallel/pipeline.py``).

A homogeneous stack of S blocks is split layer-wise over the ranks of a
``stage`` mesh, one process a rank: stage s holds its slice ``(1, ...)``
of every stacked ``(S, ...)`` parameter leaf. A global batch is split
into M microbatches; :func:`pipeline_apply` runs the M + S - 1 tick
schedule (at tick t stage s runs microbatch t - s, when there is one),
sending each stage's activations to the next with ``dist.send`` /
``dist.recv``, and the last stage's outputs reach every rank by a
broadcast (the JAX package's ``psum`` of the collected outputs). The
schedule is one ``autograd.Function``: its backward runs the ticks in
reverse, each stage recomputing its block on the saved input of a
microbatch (activation recompute, one block at a time), taking the
block's vector-Jacobian product and sending the input's gradient to the
previous stage; the parameter gradients sum over the microbatches (GPipe:
one update a global batch). :class:`GPipeTrainer` wires the schedule to a
loss, averaged over microbatches, and one of the port's updaters
stepping each stage's slice. With one stage it is the sequential stack.
``block_fn(params_slice, x) -> y`` takes torch tensors (``params_slice``
the stage's leaves without the leading axis) and keeps x's shape.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel.mesh import P, Sharding

STAGE_AXIS = "stage"

__all__ = ["GPipeTrainer", "PipelineMesh", "make_pipeline_mesh", "pipeline_apply",
           "stage_shardings", "STAGE_AXIS"]


class PipelineMesh:
    """A 1-D mesh of ranks over ``stage``: ``group`` (None for the default
    group or a single stage), the number of stages, this rank's stage and
    device."""

    def __init__(self, stages: int, stage: int, device: torch.device, group=None):
        self.stages, self.stage, self.device, self.group = int(stages), int(stage), device, group

    @property
    def shape(self) -> dict:
        return {STAGE_AXIS: self.stages}

    def peer(self, stage: int) -> int:
        """The global rank of ``stage``."""
        import torch.distributed as dist
        return stage if self.group is None else dist.get_global_rank(self.group, stage)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"PipelineMesh(stages={self.stages}, stage={self.stage}, device={self.device})"


def make_pipeline_mesh(n_stages: Optional[int] = None, devices=None,
                       device=None) -> PipelineMesh:
    """A mesh of ``n_stages`` stages (every rank of the ``torch.distributed``
    group by default, one with none): rank r is stage r. Fewer stages than
    ranks builds a group of the first ``n_stages`` ranks (a collective
    call); a rank outside it raises. ``devices`` (the JAX signature) may
    name this process's one device; ``device`` does the same."""
    import torch.distributed as dist
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(f"make_pipeline_mesh(devices=) got {len(devices)} devices: a "
                             "process drives one device, a stage a rank")
        device = devices[0] if device is None else device
    up = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    n = n_stages or world
    if n > world:
        raise ValueError(f"Requested {n} pipeline stages but only {world} devices "
                         "are available")
    group = None
    if up and n < world:
        group = dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the {n}-stage pipeline mesh")
    return PipelineMesh(n, rank, resolve_device(device), group if n > 1 else None)


def stage_shardings(mesh: PipelineMesh, stacked_params):
    """Each stacked leaf's placement: its leading axis over ``stage``."""
    return tree_map(lambda a: Sharding(mesh, P(STAGE_AXIS)), stacked_params)


def _as_tensor(a, device):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _send(t, mesh, stage):
    import torch.distributed as dist
    dist.send(t.contiguous(), mesh.peer(stage), group=mesh.group)


def _recv(like, mesh, stage):
    import torch.distributed as dist
    buf = torch.empty_like(like)
    dist.recv(buf, mesh.peer(stage), group=mesh.group)
    return buf


class _Pipeline(torch.autograd.Function):
    """The tick schedule forward and in reverse (see the module
    docstring). Inputs: the microbatches, then this stage's parameter
    leaves without the leading axis."""

    @staticmethod
    def forward(ctx, block_fn, tree, mesh, xs, *leaves):
        S, s, M = mesh.stages, mesh.stage, xs.shape[0]
        params = _rebuild(tree, leaves)
        inputs, outs = [None] * M, [None] * M
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:
                continue
            x = xs[m] if s == 0 else _recv(xs[m], mesh, s - 1)
            inputs[m] = x
            y = block_fn(params, x)
            if s < S - 1:
                _send(y, mesh, s + 1)
            else:
                outs[m] = y
        out = torch.stack(outs) if s == S - 1 else torch.empty_like(xs)
        if S > 1:
            import torch.distributed as dist
            dist.broadcast(out, mesh.peer(S - 1), group=mesh.group)
        ctx.block_fn, ctx.tree, ctx.mesh = block_fn, tree, mesh
        ctx.save_for_backward(torch.stack(inputs), *leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        mesh, S = ctx.mesh, ctx.mesh.stages
        s = mesh.stage
        inputs, *leaves = ctx.saved_tensors
        M = inputs.shape[0]
        grads = [torch.zeros_like(p) for p in leaves]
        g_xs = torch.zeros_like(inputs) if s == 0 else None
        for t in reversed(range(M + S - 1)):
            m = t - s
            if not 0 <= m < M:
                continue
            g = g_out[m] if s == S - 1 else _recv(inputs[m], mesh, s + 1)
            with torch.enable_grad():
                x = inputs[m].detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(True) for p in leaves]
                y = ctx.block_fn(_rebuild(ctx.tree, ps), x)
                gx, *gp = torch.autograd.grad(y, [x] + ps, g, allow_unused=True)
            for acc, gi in zip(grads, gp):
                if gi is not None:
                    acc.add_(gi)
            if s > 0:
                _send(gx, mesh, s - 1)
            else:
                g_xs[m] = gx
        if ctx.needs_input_grad[3]:
            if g_xs is None:
                g_xs = torch.empty_like(inputs)
            if S > 1:
                import torch.distributed as dist
                dist.broadcast(g_xs, mesh.peer(0), group=mesh.group)
        else:
            g_xs = None
        return (None, None, None, g_xs, *grads)


def pipeline_apply(block_fn: Callable, stacked_params, x_microbatches, mesh: PipelineMesh):
    """Run M microbatches through the S pipelined stages.

    ``stacked_params``: this stage's slice, leaves ``(1, ...)`` as
    :meth:`GPipeTrainer.place` returns them; ``x_microbatches``: ``(M, mb,
    ...)``, the same on every rank. Returns the ``(M, mb, ...)`` outputs of
    the last stage on every rank; differentiable in the parameters and the
    input."""
    tree = tree_map(lambda a: None, stacked_params)
    leaves = [a[0] for a in tree_leaves(stacked_params)]
    xs = _as_tensor(x_microbatches, mesh.device)
    return _Pipeline.apply(block_fn, tree, mesh, xs, *leaves)


class GPipeTrainer:
    """Train a homogeneous block stack with pipelined forward and backward.

    Example (per rank)::

        mesh = make_pipeline_mesh(4)
        tr = GPipeTrainer(block_fn, loss_fn, Sgd(0.1), mesh)
        params = tr.place(stacked_params)         # this stage's slice
        opt = tr.init_opt(params)
        params, opt, loss = tr.step(params, opt, x_microbatches, y_microbatches)

    ``loss_fn(y_pred, y) -> scalar`` is applied per microbatch and averaged
    (exact GPipe gradient accumulation); ``updater`` is one of the port's
    updaters (``optimize/updaters.py``), stepping each stage's slice once a
    global batch. Every rank returns the same loss."""

    def __init__(self, block_fn: Callable, loss_fn: Callable, updater,
                 mesh: Optional[PipelineMesh] = None):
        self.block_fn = block_fn
        self.loss_fn = loss_fn
        self.mesh = mesh if mesh is not None else make_pipeline_mesh()
        self.updater = updater

    def place(self, stacked_params):
        """This stage's ``(1, ...)`` slice of each ``(S, ...)`` leaf (numpy
        or torch), on the mesh's device."""
        s, S = self.mesh.stage, self.mesh.stages

        def cut(a):
            t = _as_tensor(a, self.mesh.device)
            if t.shape[0] != S:
                raise ValueError(f"a stacked leaf has {t.shape[0]} stages, the mesh {S}")
            return t[s:s + 1].clone()

        return tree_map(cut, stacked_params)

    def init_opt(self, stacked_params):
        return self.updater.init_state(stacked_params)

    def loss(self, params, x_microbatches, y_microbatches):
        """The mean over microbatches of ``loss_fn`` on the pipeline's
        output (differentiable)."""
        preds = pipeline_apply(self.block_fn, params, x_microbatches, self.mesh)
        ys = _as_tensor(y_microbatches, self.mesh.device)
        return torch.stack([self.loss_fn(p, y) for p, y in zip(preds, ys)]).mean()

    def step(self, params, opt_state, x_microbatches, y_microbatches):
        """One update of this stage's slice: ``(params, opt_state, loss)``."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = self.loss(_rebuild(params, leaves), x_microbatches, y_microbatches)
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = self.updater.update(_rebuild(params, list(grads)), opt_state)
        new = tree_map(lambda p, u: (p + u).detach(), params, updates)
        return new, opt_state, loss.detach()
