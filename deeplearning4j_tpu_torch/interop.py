"""Weights and configurations carried across from the JAX package.

The port never imports the JAX package. What crosses is data: the JSON that
``to_json()`` writes there, and the network's parameters and running stats
as numpy arrays (``np.asarray`` of each leaf). Both packages keep the same
layouts (NHWC/HWIO, dense ``(n_in, n_out)``, packed int4
``(n_out, ceil(fan_in/2))``), so the arrays are taken as they are.

    conf = conf_from_jax_json(jax_net.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu")
    net.params = params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jax_net.params],
        device="cpu")

    gconf = graph_conf_from_jax_json(jax_graph.conf.to_json())
    graph = ComputationGraph(gconf, device="cpu").set_params(
        params_from_jax(host(jax_graph.params), device="cpu"),
        state_from_jax(host(jax_graph.state), device="cpu"))

where ``host`` maps each leaf of the per-vertex dicts to ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

__all__ = ["params_from_jax", "state_from_jax", "conf_from_jax_json",
           "graph_conf_from_jax_json"]


def _tensors(tree, device):
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    if isinstance(tree, dict):  # a graph's per-vertex dicts
        return {name: conv(p) for name, p in tree.items()}
    return [conv(p) for p in tree]


def params_from_jax(params, device=None):
    """Per-layer dicts of numpy arrays (a list for a ``MultiLayerNetwork``, a
    dict keyed by vertex name for a ``ComputationGraph``) → the same
    structure of tensors on ``device`` (copies; dtypes kept)."""
    return _tensors(params, device)


def state_from_jax(state, device=None):
    """The running stats (``net.state``) of a JAX network, as
    :func:`params_from_jax` takes its parameters."""
    return _tensors(state, device)


def conf_from_jax_json(s: str) -> MultiLayerConfiguration:
    """A ``MultiLayerConfiguration`` written by the JAX package's ``to_json``."""
    return MultiLayerConfiguration.from_json(s)


def graph_conf_from_jax_json(s: str) -> ComputationGraphConfiguration:
    """A ``ComputationGraphConfiguration`` written by the JAX package."""
    return ComputationGraphConfiguration.from_json(s)
