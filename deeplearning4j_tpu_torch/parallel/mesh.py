"""Meshes of ranks (counterpart of ``deeplearning4j_tpu/parallel/mesh.py``).

In the JAX package a mesh is a grid of devices with the named axes
``data`` (batch sharding; the step's gradient all-reduce) and ``model``
(parameter sharding for tensor parallelism). In the port a mesh is a
``(data, model)`` grid of ``torch.distributed`` ranks, each rank one
process driving one device, with a process group per row and column:

- :func:`make_mesh` with no process group initialised is the one-device
  mesh of the calling process, as the JAX ``make_mesh()`` over
  ``jax.devices()`` is one device on one card. With a group initialised
  it lays the world's ranks out row-major over ``(dp, tp)`` and builds
  the groups (a collective call: every rank makes every mesh in the same
  order);
- :class:`Sharding` and :class:`P` stand for ``NamedSharding`` and
  ``PartitionSpec``: the per-leaf placement the JAX package computes.
  :func:`tp_param_spec` and :func:`tp_shardings` return the same specs as
  the JAX ones for the same parameter trees; :class:`TensorParallel`
  keeps each rank's slice of the sharded leaves and gathers them over the
  ``model`` group (``ParallelWrapper(tensor_parallel=True)``);
- :func:`shard_batch` places this rank's rows of a global batch on its
  device.

A mesh is a context manager that does nothing, so code written for the
JAX package's ``with mesh:`` reads the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.tree import tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "P", "Sharding", "MultiRankMeshError",
           "make_mesh", "replicated", "data_sharding", "shard_batch", "tp_param_spec",
           "tp_shardings", "local_device_of", "TensorParallel"]


class MultiRankMeshError(ValueError):
    """A mesh of several ranks was given where each rank works on its own
    device (serving, prefetching): build one per rank over ``make_mesh()``
    of that rank's device instead."""


class P(tuple):
    """A partition spec: one mesh-axis name (or None) per array axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P({', '.join(repr(a) for a in self)})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement over a mesh (``NamedSharding``'s counterpart)."""
    mesh: "Mesh"
    spec: P


class Mesh:
    """A ``(data, model)`` grid of ranks; see the module docstring.
    ``ranks[i, j]`` is the rank at data index i and model index j;
    ``device`` is the one this process drives; ``data_group`` /
    ``model_group`` are this rank's column and row groups (None at one
    rank)."""

    def __init__(self, ranks: np.ndarray, device: torch.device, rank: int = 0,
                 data_group=None, model_group=None):
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(ranks.shape[0], -1)
        self.device = device
        self.rank = int(rank)
        self.data_group = data_group
        self.model_group = model_group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: int(self.ranks.shape[0]), MODEL_AXIS: int(self.ranks.shape[1])}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def data_index(self) -> int:
        """This rank's row (its shard of the batch)."""
        return int(np.argwhere(self.ranks == self.rank)[0][0])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"Mesh(shape={self.shape}, rank={self.rank}, device={self.device})"


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices=None, device=None) -> Mesh:
    """A ``(data, model)`` mesh. ``dp`` defaults to n // tp, n the
    ``torch.distributed`` world size (1 with no group). ``devices`` (the
    JAX signature) may name this process's one device; ``device`` does the
    same (the port's device rule: ``cuda`` unless ``"cpu"``)."""
    import torch.distributed as dist
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise MultiRankMeshError(
                f"make_mesh(devices=) got {len(devices)} devices: a process drives one "
                "device; a mesh of several is one rank a device under torch.distributed")
        device = devices[0] if device is None else device
    rank, n = _world()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"dp*tp = {dp * tp} exceeds {n} ranks")
    ranks = np.arange(dp * tp).reshape(dp, tp)
    dev = resolve_device(device)
    data_group = model_group = None
    if rank >= dp * tp:
        raise ValueError(f"rank {rank} is outside the {dp}x{tp} mesh")
    if n > 1 and (tp > 1 or dp < n):
        # every rank builds every group in the same order (new_group is
        # collective); each keeps the two holding it. A (n, 1) mesh uses
        # the default group for its data axis and needs none for 'model'
        for j in range(tp):
            g = dist.new_group([int(r) for r in ranks[:, j]])
            if rank in ranks[:, j]:
                data_group = g
        for i in range(dp):
            g = dist.new_group([int(r) for r in ranks[i, :]])
            if rank in ranks[i, :]:
                model_group = g
    return Mesh(ranks, dev, rank, data_group, model_group)


def local_device_of(mesh: Optional[Mesh], device=None, what: str = "this"):
    """The device a one-rank ``mesh`` names (``device`` when there is no
    mesh). A mesh of several ranks raises :class:`MultiRankMeshError`:
    each rank serves or prefetches on its own device."""
    if mesh is None:
        return device
    if mesh.size > 1:
        raise MultiRankMeshError(
            f"{what}(mesh=) got a mesh of {mesh.size} ranks: in the PyTorch port each "
            "rank serves and prefetches on its own device (a difference kept by "
            "design, ROADMAP §C2); pass each rank's make_mesh() of one device (or "
            "device=) instead")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"{what}: device={device} is not the mesh's device {mesh.device}")
    return mesh.device


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


def data_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading (batch) axis over ``data``."""
    return Sharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def shard_batch(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's contiguous rows of the global array ``arr``, on its
    device (the whole array on a one-rank mesh)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    dp = mesh.shape[DATA_AXIS]
    n = int(t.shape[0])
    if n % dp:
        raise ValueError(f"Global batch {n} not divisible by data-parallel size {dp}")
    k = n // dp
    i = mesh.data_index
    return t[i * k:(i + 1) * k].to(mesh.device)


def tp_param_spec(key: str, shape) -> P:
    """The tensor-parallel spec of one parameter (the JAX package's
    convention, megatron-style column sharding on the output dimension):
    matmul weights (n_in, n_out) -> P(None, 'model'); HWIO conv kernels
    -> P(None, None, None, 'model'); conv1d WIO -> P(None, None,
    'model'); biases and per-feature vectors -> P('model'); the rest
    replicated."""
    ndim = len(shape)
    if key in ("W", "U", "W_pw") and ndim == 2:
        return P(None, MODEL_AXIS)
    if key in ("W", "W_dw", "W_pw") and ndim == 4:
        return P(None, None, None, MODEL_AXIS)
    if key == "W" and ndim == 3:
        return P(None, None, MODEL_AXIS)
    if ndim == 1 and key in ("b", "gamma", "beta"):
        return P(MODEL_AXIS)
    return P()


def tp_shardings(mesh: Mesh, params):
    """A params-shaped tree of :class:`Sharding`: each leaf's
    :func:`tp_param_spec` by its innermost dict key, replicated where the
    sharded dimension does not divide the ``model`` axis."""
    tp = mesh.shape[MODEL_AXIS]

    def leaf(key, a):
        spec = tp_param_spec(key or "", tuple(a.shape))
        for axis_idx, axis_name in enumerate(spec):
            if axis_name == MODEL_AXIS and a.shape[axis_idx] % tp:
                return Sharding(mesh, P())
        return Sharding(mesh, spec)

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, key) for v in tree]
        return leaf(key, tree)

    return walk(params, None)


class _Gather(torch.autograd.Function):
    """This rank's slice -> the whole leaf, along ``axis`` over the model
    group. Every rank of the group computes the same loss from the whole
    leaf, so the gradient of this rank's slice is its slice of the whole
    leaf's gradient (no sum over the group)."""

    @staticmethod
    def forward(ctx, x, axis, group, size, index):
        import torch.distributed as dist
        ctx.slice = (axis, index, x.shape[axis])
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        axis, index, k = ctx.slice
        return g.narrow(axis, index * k, k), None, None, None, None


class TensorParallel:
    """This rank's placement of a parameter tree under
    :func:`tp_shardings`: :meth:`shard` keeps this rank's slice of every
    leaf whose spec names ``model`` (its index along the mesh's ``model``
    axis), :meth:`gather` rebuilds the whole leaves over the model group
    (differentiably on request). Trees that mirror the parameters (updater
    slots, a compression residual) go through the same calls. On a
    ``model`` axis of one rank both are the identity."""

    def __init__(self, mesh: Mesh, params):
        self.mesh = mesh
        self.size = mesh.shape[MODEL_AXIS]
        self.group = mesh.model_group
        self.index = 0
        if self.size > 1:
            import torch.distributed as dist
            self.index = dist.get_rank(self.group)
        self.axes = tree_map(lambda sh: next((i for i, a in enumerate(sh.spec)
                                               if a == MODEL_AXIS), None),
                              tp_shardings(mesh, params))

    def shard(self, tree, axes=None):
        """This rank's contiguous slice of each sharded leaf of ``tree`` (a
        parameter tree, or a subtree mirroring the one ``axes`` names)."""
        def cut(a, axis):
            if axis is None or self.size == 1:
                return a
            k = a.shape[axis] // self.size
            return a.narrow(axis, self.index * k, k).contiguous()
        return tree_map(cut, tree, self.axes if axes is None else axes)

    def gather(self, tree, axes=None, differentiable: bool = False):
        """The whole leaves of a tree of slices, gathered over the model
        group; with ``differentiable`` the gradient reaches the slices."""
        def whole(a, axis):
            if axis is None or self.size == 1:
                return a
            if differentiable:
                return _Gather.apply(a, axis, self.group, self.size, self.index)
            with torch.no_grad():
                return _Gather.apply(a, axis, self.group, self.size, self.index)
        return tree_map(whole, tree, self.axes if axes is None else axes)

