"""Bucketed ("horizontally fused") optimizer updates for small parameters
(counterpart of ``deeplearning4j_tpu/optimize/fused_update.py``).

A network's updater runs once for each parameter tensor, and each run is a
dozen elementwise launches over a tensor of a few KB: ResNet50 has 161
leaves, 107 of them biases and batch-norm scales. The reference flattens
the parameters that share an updater configuration into one buffer so the
updater runs as one vectorized op (UpdaterBlock); the JAX package
concatenates the small leaves of each (updater, dtype) bucket and runs the
update once over the flat vector. PyTorch's idiom for the same horizontal
update is ``torch._foreach_*``: one call for each elementwise step of the
updater's formula, over the bucket's member lists, in place on the
parameters and the slots. Nothing is concatenated or scattered back.

The plan is the JAX package's:

- only leaves of rank <= 1 with at most ``threshold`` elements
  (``DEFAULT_THRESHOLD``) are bucketed; convolution and dense kernels stay
  on the per-tensor path;
- a bucket is keyed by ``(repr(updater), dtype)``; a bucket of one member
  stays per-tensor;
- updater classes outside ``_N_ACCS`` (``NoOp`` among them) take the
  per-tensor path.

The stored updater state is unchanged: per layer, ``{"count": int, <slot>:
tree}`` as ``optimize/updaters.py`` keeps it, so checkpoints and the JAX
package's zips read and write as before. Counts are host integers, so the
members of a bucket whose counts differ (a partial ``pretrain``) run in
separate groups, each with the per-tensor path's bias-correction scalars.

Each updater class writes its own list form (``_foreach_direction`` in
``optimize/updaters.py``, beside its per-tensor ``_direction``), with the
per-tensor formula's operations in the same order and rounding, so the
bucketed result equals the per-tensor one bitwise. The leaves left out of
the buckets take ``Updater.update``, one leaf at a time.

``threshold=0`` is the per-tensor path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.updaters import (AdaDelta, AdaGrad, AdaMax, Adam,
                                                        Nadam, Nesterovs, NoOp, RmsProp, Sgd)

# updater class -> number of parameter-shaped slot trees its state carries
_N_ACCS = {Sgd: 0, Nesterovs: 1, Adam: 2, Nadam: 2, AdaMax: 2,
           AdaGrad: 1, RmsProp: 1, AdaDelta: 2}

DEFAULT_THRESHOLD = 1 << 16  # leaves with <= this many elements are bucketed

__all__ = ["bucketed_apply", "plan_buckets", "DEFAULT_THRESHOLD"]


def _foreach_step(u, p, g, slots: List[List[torch.Tensor]], count: int):
    """One step of updater ``u`` over the member lists ``p`` (parameters),
    ``g`` (gradients) and ``slots`` (one list a slot, in ``u._slots``
    order), in place on ``p`` and ``slots``. ``count`` is the members'
    count before the step."""
    d = u._foreach_direction(g, slots, count + 1)
    torch._foreach_add_(p, torch._foreach_mul(d, -u.lr(count)))


def _set_leaves(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def plan_buckets(keys: Sequence, updaters: Dict, params,
                 threshold: int = DEFAULT_THRESHOLD) -> Dict[tuple, list]:
    """The JAX package's bucket plan: ``{(repr(updater), dtype): [updater,
    [(key, leaf index), ...]]}`` over the small rank <= 1 leaves of the
    layers in ``keys`` whose updater class has a bucketed form, leaves in
    ``tree_leaves`` order. A bucket of one member runs per tensor."""
    buckets: Dict[tuple, list] = {}
    for k in keys:
        u = updaters[k]
        if type(u) not in _N_ACCS:
            continue
        for i, p in enumerate(tree_leaves(params[k])):
            if p.dim() <= 1 and p.numel() <= threshold:
                buckets.setdefault((repr(u), str(p.dtype)), [u, []])[1].append((k, i))
    return buckets


def bucketed_apply(keys: Sequence, updaters: Dict, gnorms: Dict, params, grads, opt_state,
                   threshold: int = DEFAULT_THRESHOLD):
    """One updater step for every layer (or vertex) in ``keys``, in place:
    ``params[k]`` gets its update added, ``opt_state[k]`` its new slots and
    count. ``updaters[k]`` is the layer's updater, ``gnorms[k]`` its
    gradient normalization, ``grads[k]`` its gradient tree; ``params``,
    ``grads`` and ``opt_state`` are the networks' dicts (graph) or lists
    (MultiLayerNetwork). The caller applies constraints afterwards.

    Small rank <= 1 leaves run bucketed (``plan_buckets``); every other
    leaf takes its updater's per-tensor step. A ``NoOp`` layer only counts
    the step: its update is zero, and adding zero leaves every parameter
    bitwise as it was. ``threshold=0`` buckets nothing."""
    live = []
    for k in keys:
        if not tree_leaves(params[k]) or isinstance(updaters[k], NoOp):
            # a layer without parameters (or frozen) still counts the step,
            # as optax's state does, so every layer's count is the network's
            opt_state[k]["count"] += 1
        else:
            live.append(k)
    normed = {k: tree_leaves(gnorms[k](grads[k])) for k in live}
    slot_leaves = {k: [tree_leaves(opt_state[k][s]) for s in updaters[k]._slots]
                   for k in live}
    bucketed = set()
    for u, members in plan_buckets(live, updaters, params, threshold).values():
        if len(members) < 2:
            continue
        bucketed.update(members)
        groups: Dict[int, list] = {}
        for k, i in members:
            groups.setdefault(opt_state[k]["count"], []).append((k, i))
        for count, group in groups.items():
            _foreach_step(u, [tree_leaves(params[k])[i] for k, i in group],
                          [normed[k][i] for k, i in group],
                          [[slot_leaves[k][j][i] for k, i in group]
                           for j in range(len(u._slots))], count)
    for k in live:
        u, state = updaters[k], opt_state[k]
        count = state["count"]
        for i, p in enumerate(tree_leaves(params[k])):
            if (k, i) in bucketed:
                continue
            upd, new = u.update(normed[k][i], {"count": count, **{
                s: slot_leaves[k][j][i] for j, s in enumerate(u._slots)}})
            p.add_(upd)
            for j, s in enumerate(u._slots):
                slot_leaves[k][j][i] = new[s]
        for j, s in enumerate(u._slots):
            state[s] = _set_leaves(state[s], slot_leaves[k][j])
        state["count"] = count + 1
