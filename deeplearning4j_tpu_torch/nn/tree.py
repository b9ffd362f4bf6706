"""Nested dicts (and lists) of tensors, walked as the JAX package walks its
pytrees.

A layer's parameters are a dict whose values are tensors or, for the
attention layers' ``q``/``k``/``v``/``o`` groups, dicts of tensors; a
``MultiLayerNetwork`` keeps a list of them. Every walk over parameters,
gradients and updater state goes through these functions, at any depth.
"""

from __future__ import annotations

import torch

__all__ = ["tree_map", "tree_leaves", "leaf_grads"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first, in the dicts' own key order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def leaf_grads(loss, leaves):
    """Gradients of ``loss`` for every tensor of the tree ``leaves`` (which
    require grad), in the same structure; a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives."""
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True) if flat else ())

    def one(v):
        g = next(grads)
        return torch.zeros_like(v) if g is None else g

    return tree_map(one, leaves)
