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

A vector index crosses as the ``.npz`` its ``save()`` writes (centroids,
codebooks, codes, ids, offsets, scales and norms as numpy arrays, and a
JSON meta entry); both packages write and read the same format:

    jax_index.save("ix.npz")
    ix = index_from_jax("ix.npz", device="cpu")

Word vectors cross as the JAX package's model zip (``config.json``,
``vocab.json``, ``syn0.npy``, ``syn1.npy``), or as numpy arrays:

    WordVectorSerializer.write_word2vec_model(jax_w2v, "w2v.zip")
    w2v = word2vec_from_jax("w2v.zip", device="cpu")
    sv = sequence_vectors_from_jax(jax_w2v.vocab.words(),
                                   [vw.count for vw in jax_w2v.vocab.vocab_words()],
                                   np.asarray(jax_w2v.syn0), np.asarray(jax_w2v.syn1),
                                   {"layer_size": 32, "negative": 5}, device="cpu")
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

__all__ = ["params_from_jax", "state_from_jax", "conf_from_jax_json",
           "graph_conf_from_jax_json", "index_from_jax", "word2vec_from_jax",
           "sequence_vectors_from_jax"]


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


def index_from_jax(path, device=None):
    """The port's index over an ``.npz`` written by the JAX package's
    ``save()`` (brute-force fp32/int8/int4, PQ or IVF-PQ), on ``device``."""
    from deeplearning4j_tpu_torch.retrieval.index import load_index
    return load_index(path, device)


def word2vec_from_jax(path, device=None):
    """The port's ``Word2Vec`` over a model zip written by the JAX package's
    ``WordVectorSerializer.write_word2vec_model``, tables on ``device``."""
    from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
    return WordVectorSerializer.read_word2vec_model(path, device)


def sequence_vectors_from_jax(words, counts, syn0, syn1, config, device=None):
    """A port ``Word2Vec`` from a JAX model's parts: vocab words in index
    order, their counts, the (V, D) ``syn0`` / ``syn1`` as numpy arrays and
    the constructor keywords (``layer_size``, ``negative``, ...)."""
    from deeplearning4j_tpu_torch.nlp.serializer import restore_word2vec
    return restore_word2vec(config, words, counts, syn0, syn1, device)
