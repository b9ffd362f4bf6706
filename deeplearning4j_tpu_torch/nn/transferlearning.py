"""Transfer learning: freeze, replace and append layers of trained networks
(counterpart of ``deeplearning4j_tpu/nn/transferlearning.py``; reference
TransferLearning.java with its Builder and GraphBuilder,
FineTuneConfiguration.java, TransferLearningHelper.java).

Freezing is a ``NoOp`` updater on the frozen layers, as in the JAX package
(and under the reference's FrozenLayer). The port's train step hands a
frozen layer's parameters to autograd no more (``nn/training.py``), so no
backward runs for a frozen prefix: a ResNet50 frozen up to ``res4f_out``
runs the batch-norm backward kernel for the 10 fused blocks of ``res5``
only, as XLA drops the trunk's backward from the JAX step. Frozen
batch-norm layers still run in train mode (batch statistics, running
statistics updated), because the JAX package's step runs every layer's
train forward; DL4J's FrozenLayer runs them in inference mode.

Retained layers keep their trained parameters and state, copied as fresh
tensors on the new network's device wherever the structure and shapes
match (``_copy_matching``); a resized or added layer starts from the new
network's own init.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.updaters import NoOp, Updater

__all__ = ["FineTuneConfiguration", "TransferLearning", "TransferLearningHelper"]


def _graph_ancestors(vertices, names):
    """Transitive input closure (``names`` included) over a mapping name ->
    (obj, input names)."""
    seen = set()
    stack = list(names)
    while stack:
        cur = stack.pop()
        if cur in seen or cur not in vertices:
            continue
        seen.add(cur)
        stack.extend(vertices[cur][1])
    return seen


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


def _copy_matching(src_params, src_state, dst_params, dst_state, name, device) -> bool:
    """Copy one layer's (or vertex's) parameters and state from src to dst
    when the trees have the same structure and leaf shapes, as fresh
    tensors on ``device``. Returns whether it copied."""
    src, dst = src_params[name], dst_params[name]
    if _structure(src) != _structure(dst):
        return False
    if not all(a.shape == b.shape for a, b in zip(tree_leaves(src), tree_leaves(dst))):
        return False

    def fresh(t):
        return t.detach().to(device, copy=True)

    dst_params[name] = tree_map(fresh, src)
    dst_state[name] = tree_map(fresh, src_state[name])
    return True


@dataclasses.dataclass(frozen=True)
class FineTuneConfiguration:
    """Overrides applied to every layer that is not frozen (reference
    FineTuneConfiguration.java)."""

    updater: Optional[Updater] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    weight_init: Optional[str] = None
    seed: Optional[int] = None

    def _apply(self, layer):
        updates = {}
        for f in ("updater", "l1", "l2", "dropout", "weight_init"):
            v = getattr(self, f)
            if v is not None and hasattr(layer, f):
                updates[f] = v
        return dataclasses.replace(layer, **updates) if updates else layer

    def _conf_overrides(self, old) -> dict:
        return {"seed": self.seed if self.seed is not None else old.seed,
                "updater": self.updater if self.updater is not None else old.updater}


class TransferLearning:
    """Entry point mirroring ``new TransferLearning.Builder(net)``."""

    class Builder:
        """MultiLayerNetwork transfer learning (reference
        TransferLearning.Builder)."""

        def __init__(self, net: MultiLayerNetwork):
            if net.params is None:
                net.init()
            self._net = net
            self._layers = list(net.conf.layers)
            self._keep_params: List[bool] = [True] * len(self._layers)
            self._frozen_upto = -1
            self._fine_tune: Optional[FineTuneConfiguration] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers [0..layer_index] (reference setFeatureExtractor)."""
            self._frozen_upto = layer_index
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            for _ in range(n):
                self._layers.pop()
                self._keep_params.pop()
            return self

        def add_layer(self, layer):
            self._layers.append(layer)
            self._keep_params.append(False)
            return self

        def n_out_replace(self, layer_index: int, n_out: int,
                          weight_init: Optional[str] = None):
            """Resize a layer's output, re-initializing it and the next
            layer, whose n_in is inferred anew (reference nOutReplace)."""
            layer = self._layers[layer_index]
            updates = {"n_out": n_out}
            if weight_init is not None:
                updates["weight_init"] = weight_init
            self._layers[layer_index] = dataclasses.replace(layer, **updates)
            self._keep_params[layer_index] = False
            if layer_index + 1 < len(self._layers):
                nxt = self._layers[layer_index + 1]
                if hasattr(nxt, "n_in"):
                    self._layers[layer_index + 1] = dataclasses.replace(nxt, n_in=None)
                    self._keep_params[layer_index + 1] = False
            return self

        def build(self) -> MultiLayerNetwork:
            layers = []
            for i, layer in enumerate(self._layers):
                if i <= self._frozen_upto:
                    if hasattr(layer, "updater"):
                        layer = dataclasses.replace(layer, updater=NoOp())
                elif self._fine_tune is not None:
                    layer = self._fine_tune._apply(layer)
                layers.append(layer)
            old = self._net.conf
            over = (self._fine_tune._conf_overrides(old) if self._fine_tune is not None
                    else {})
            conf = dataclasses.replace(old, layers=tuple(layers), **over)
            new_net = MultiLayerNetwork(conf, self._net.device).init()
            for i, keep in enumerate(self._keep_params):
                if keep and i < len(self._net.params):
                    _copy_matching(self._net.params, self._net.state, new_net.params,
                                   new_net.state, i, new_net.device)
            return new_net

    class GraphBuilder:
        """ComputationGraph transfer learning (reference
        TransferLearning.java:447 GraphBuilder: setFeatureExtractor,
        removeVertexAndConnections, addLayer, addVertex, setOutputs,
        nOutReplace). Retained vertices keep their trained parameters;
        frozen ones train with a NoOp updater."""

        def __init__(self, net):
            if not isinstance(net, ComputationGraph):
                raise TypeError("GraphBuilder wraps a ComputationGraph; use "
                                "TransferLearning.Builder for MLNs")
            if net.params is None:
                net.init()
            self._net = net
            self._vertices = {n: (obj, tuple(ins)) for n, (obj, ins) in net.conf.vertices.items()}
            self._outputs = list(net.conf.network_outputs)
            self._keep = {n: True for n in self._vertices}
            self._frozen: set = set()
            self._fine_tune: Optional[FineTuneConfiguration] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and everything upstream of them
            (reference setFeatureExtractor(String...))."""
            for v in vertex_names:
                if v not in self._vertices:
                    raise KeyError(f"Unknown vertex '{v}'")
            self._frozen = _graph_ancestors(self._vertices, vertex_names)
            return self

        def remove_vertex_and_connections(self, name: str):
            """Remove the vertex and its edges: consumers drop it from their
            inputs and otherwise survive (reference
            removeVertexAndConnections); a consumer left with no input fails
            validation at ``build()``."""
            if name not in self._vertices:
                raise KeyError(f"Unknown vertex '{name}'")
            del self._vertices[name]
            self._keep.pop(name, None)
            self._frozen.discard(name)
            for n, (obj, ins) in list(self._vertices.items()):
                if name in ins:
                    self._vertices[n] = (obj, tuple(i for i in ins if i != name))
            self._outputs = [o for o in self._outputs if o != name]
            return self

        def remove_vertex_keep_connections(self, name: str):
            """Remove only the named vertex; a vertex of the same name must
            be added before ``build()`` (reference
            removeVertexKeepConnections)."""
            if name not in self._vertices:
                raise KeyError(f"Unknown vertex '{name}'")
            del self._vertices[name]
            self._keep.pop(name, None)
            self._frozen.discard(name)
            return self

        def add_layer(self, name: str, layer, *inputs: str):
            self._vertices[name] = (layer, tuple(inputs))
            self._keep[name] = False
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            self._vertices[name] = (vertex, tuple(inputs))
            self._keep[name] = False
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def n_out_replace(self, name: str, n_out: int, weight_init: Optional[str] = None):
            """Resize a layer vertex's output, re-initializing it; its
            consumers re-initialize where their shapes no longer match
            (reference nOutReplace)."""
            obj, ins = self._vertices[name]
            updates = {"n_out": n_out}
            if weight_init is not None:
                updates["weight_init"] = weight_init
            self._vertices[name] = (dataclasses.replace(obj, **updates), ins)
            self._keep[name] = False
            return self

        def build(self) -> ComputationGraph:
            vertices = {}
            for n, (obj, ins) in self._vertices.items():
                if isinstance(obj, Layer):
                    if n in self._frozen:
                        if hasattr(obj, "updater"):
                            obj = dataclasses.replace(obj, updater=NoOp())
                    elif self._fine_tune is not None:
                        obj = self._fine_tune._apply(obj)
                vertices[n] = (obj, ins)
            old = self._net.conf
            over = (self._fine_tune._conf_overrides(old) if self._fine_tune is not None
                    else {})
            conf = dataclasses.replace(old, vertices=vertices,
                                       network_outputs=tuple(self._outputs), **over)
            new_net = ComputationGraph(conf, self._net.device).init()
            for n, keep in self._keep.items():
                if keep and n in self._net.params:
                    _copy_matching(self._net.params, self._net.state, new_net.params,
                                   new_net.state, n, new_net.device)
            return new_net


class TransferLearningHelper:
    """Featurize through the frozen layers, then train only the rest on the
    features (reference TransferLearningHelper.java).

    MultiLayerNetwork form: ``TransferLearningHelper(mln, frozen_upto_index)``.
    Graph form: ``TransferLearningHelper(graph, "boundary_vertex", ...)``:
    the named vertices and everything upstream are the frozen trunk;
    ``featurize`` returns their activations and ``unfrozen_graph()`` is a
    trainable sub-graph whose inputs are those activations."""

    def __init__(self, net, *frozen_boundary, frozen_upto: Optional[int] = None):
        self._graph_mode = isinstance(net, ComputationGraph)
        self._net = net
        if not self._graph_mode:
            if frozen_upto is None:
                (frozen_upto,) = frozen_boundary
            self._split = frozen_upto + 1
            return
        if net.params is None:
            net.init()
        if not frozen_boundary:
            raise ValueError("graph helper needs >=1 frozen boundary vertex")
        self._boundary = [str(v) for v in frozen_boundary]
        for v in self._boundary:
            if v not in net.conf.vertices:
                raise KeyError(f"Unknown vertex '{v}'")
        self._frozen = _graph_ancestors(net.conf.vertices, self._boundary)
        self._sub = None

    def featurize(self, x):
        """The boundary activations of ``x`` (an input, or a list of one
        per network input) from the inference forward (running statistics,
        no dropout), on the network's device. The graph form runs only the
        frozen vertices and returns one tensor per boundary vertex."""
        if not self._graph_mode:
            return self._net.feed_forward(x)[self._split - 1]
        net = self._net
        xs = x if isinstance(x, (list, tuple)) else [x]
        with torch.no_grad():  # not inference_mode: the features feed autograd later
            acts = net._forward(net.params, net.state, [net._as_tensor(f) for f in xs],
                                False, only=self._frozen)[0]
        return [acts[v] for v in self._boundary]

    def unfrozen_graph(self) -> ComputationGraph:
        """The trainable sub-graph over the vertices that are not frozen;
        its inputs are the boundary vertices (and any network input an
        unfrozen vertex reads directly). Its parameters are copies of the
        full graph's."""
        if not self._graph_mode:
            raise TypeError("unfrozen_graph() is graph-mode only")
        if self._sub is not None:
            return self._sub
        conf = self._net.conf
        out_types = conf.vertex_output_types()
        keep = {n: v for n, v in conf.vertices.items() if n not in self._frozen}
        inputs, input_types = [], []
        for n in self._boundary:
            inputs.append(n)
            input_types.append(out_types[n])
        for n, (obj, ins) in keep.items():
            for i in ins:
                if (i in conf.network_inputs or i in self._frozen) and i not in inputs:
                    inputs.append(i)
                    input_types.append(out_types[i])
        sub_conf = dataclasses.replace(conf, network_inputs=tuple(inputs), vertices=keep,
                                       input_types=tuple(input_types))
        sub = ComputationGraph(sub_conf, self._net.device).init()
        for n in keep:
            if n in self._net.params:
                _copy_matching(self._net.params, self._net.state, sub.params, sub.state, n,
                               sub.device)
        self._sub = sub
        return sub

    def fit_featurized(self, features, labels, num_epochs: int = 1) -> ComputationGraph:
        """Train the unfrozen sub-graph on boundary features, then copy its
        parameters back into the full graph (reference fitFeaturized
        changes the original network's unfrozen layers). Returns the
        sub-graph."""
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        sub = self.unfrozen_graph()
        feats = features if isinstance(features, (list, tuple)) else [features]
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        sub.fit(MultiDataSet(list(feats), list(labs)), num_epochs=num_epochs)
        for n in sub.conf.vertices:
            if n in self._net.params:
                _copy_matching(sub.params, sub.state, self._net.params, self._net.state, n,
                               self._net.device)
        return sub
