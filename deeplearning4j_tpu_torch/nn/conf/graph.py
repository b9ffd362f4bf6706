"""Computation-graph configuration: vertices + DAG wiring (counterpart of
``deeplearning4j_tpu/nn/conf/graph.py``).

``ComputationGraphConfiguration.to_json``/``from_json`` use the JAX
package's schema key for key, and the topological order and shape
inference walk the DAG exactly as the JAX package does, so both packages
build the same vertex order from the same JSON. A vertex is a plain
function of its input tensors.

Features masks are threaded by the graph runtime (``nn/graph.py``):
``LastTimeStepVertex`` takes the mask of its input (or of ``mask_input``)
and returns each row's last unmasked step; ``DuplicateToTimeSeriesVertex``
takes the reference input's time length, and its output carries the
reference input's mask.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict, layer_to_dict
from deeplearning4j_tpu_torch.optimize.updaters import Sgd, Updater

_VERTEX_REGISTRY = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_to_dict(v):
    d = dataclasses.asdict(v)
    d["@class"] = type(v).__name__
    return d


def vertex_from_dict(d):
    d = dict(d)
    cls = _VERTEX_REGISTRY[d.pop("@class")]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in d.items() if k in names})


class GraphVertex:
    """Parameterless DAG node (reference nn/graph/vertex/GraphVertex.java)."""

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        raise NotImplementedError

    def to_dict(self):
        return vertex_to_dict(self)


@register_vertex
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenate along the feature (last) axis."""

    def output_type(self, *its):
        base = its[0]
        if base.kind == "rnn":
            return InputType.recurrent(sum(it.size for it in its), base.timeseries_length)
        if base.kind == "cnn":
            return InputType.convolutional(base.height, base.width,
                                           sum(it.channels for it in its))
        return InputType.feed_forward(sum(it.flat_size() for it in its))

    def apply(self, *inputs):
        return torch.cat(inputs, dim=-1)


@register_vertex
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """add|subtract|product|average|max."""

    op: str = "add"

    def apply(self, *inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract requires exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op in ("average", "avg"):
            return sum(inputs) / float(len(inputs))
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown elementwise op '{self.op}'")


@register_vertex
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """Stack along the batch axis."""

    def apply(self, *inputs):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """Slice ``from_index`` of ``stack_size`` along the batch axis."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, *inputs):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@register_vertex
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """Feature range [from_index, to_index], inclusive."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, *its):
        n = self.to_index - self.from_index + 1
        if its[0].kind == "rnn":
            return InputType.recurrent(n, its[0].timeseries_length)
        return InputType.feed_forward(n)

    def apply(self, *inputs):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """Reshape to (batch, *shape)."""

    shape: Tuple[int, ...] = ()

    def output_type(self, *its):
        if len(self.shape) == 1:
            return InputType.feed_forward(self.shape[0])
        if len(self.shape) == 3:
            return InputType.convolutional(*self.shape)
        if len(self.shape) == 2:
            return InputType.recurrent(self.shape[1], self.shape[0])
        return its[0]

    def apply(self, *inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))


@register_vertex
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, *inputs):
        return inputs[0] * self.scale


@register_vertex
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, *inputs):
        return inputs[0] + self.shift


@register_vertex
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over all but the batch axis."""

    eps: float = 1e-8

    def apply(self, *inputs):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        return x / torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True) + self.eps)


@register_vertex
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertex):
    """Pairwise L2 distance of two inputs -> (batch, 1)."""

    eps: float = 1e-8

    def output_type(self, *its):
        return InputType.feed_forward(1)

    def apply(self, *inputs):
        a, b = inputs
        d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


@register_vertex
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex."""

    preprocessor: Optional[object] = None

    def output_type(self, *its):
        return self.preprocessor.output_type(its[0])

    def apply(self, *inputs):
        return self.preprocessor.apply(inputs[0], None)[0]

    def to_dict(self):
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_to_dict
        return {"@class": "PreprocessorVertex",
                "preprocessor": preprocessor_to_dict(self.preprocessor)}


@register_vertex
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """(b, t, s) -> (b, s): each row's last unmasked step, given the
    (b, t) features mask, else the last step. The graph passes the mask of
    the vertex's input, or of ``mask_input`` when it names one."""

    mask_input: Optional[str] = None

    def output_type(self, *its):
        return InputType.feed_forward(its[0].size)

    def apply(self, *inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1, :]
        # the JAX package sums the mask and truncates to int32: a row with
        # no step kept reads step 0
        idx = torch.clamp(mask.sum(dim=1).to(torch.int32) - 1, min=0).long()
        return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0, :]


@register_vertex
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(b, s) -> (b, t, s), t the time length of ``reference_input``."""

    reference_input: Optional[str] = None

    def output_type(self, *its):
        return InputType.recurrent(its[0].flat_size())

    def apply(self, *inputs, time_steps=None):
        x = inputs[0]
        return x[:, None, :].expand(x.shape[0], time_steps, x.shape[1])


@dataclasses.dataclass(frozen=True)
class ComputationGraphConfiguration:
    """DAG config. ``vertices`` maps name -> (Layer | GraphVertex, input
    names). Network inputs are named in ``network_inputs`` with types in
    ``input_types``."""

    network_inputs: Tuple[str, ...]
    vertices: Dict[str, Tuple[object, Tuple[str, ...]]]
    network_outputs: Tuple[str, ...]
    input_types: Tuple[InputType, ...] = ()
    seed: int = 12345
    dtype: str = "float32"
    updater: Updater = Sgd(learning_rate=0.1)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def __post_init__(self):
        if self.backprop_type not in ("standard", "tbptt"):
            raise ValueError(
                f"Unknown backprop_type '{self.backprop_type}' "
                "(expected 'standard' or 'tbptt')")
        if (self.backprop_type == "tbptt"
                and self.tbptt_fwd_length != self.tbptt_back_length):
            raise ValueError(
                "tbptt_back_length != tbptt_fwd_length is not supported: got "
                f"fwd={self.tbptt_fwd_length}, back={self.tbptt_back_length}. "
                "Use equal lengths")

    def topological_order(self) -> List[str]:
        """Kahn's order with a LIFO frontier, as the JAX package walks it."""
        indeg = {}
        children = {n: [] for n in list(self.vertices) + list(self.network_inputs)}
        for name, (_, inputs) in self.vertices.items():
            indeg[name] = len(inputs)
            for i in inputs:
                if i not in children:
                    raise ValueError(f"Vertex '{name}' references unknown input '{i}'")
                children[i].append(name)
        order = []
        frontier = list(self.network_inputs)
        while frontier:
            cur = frontier.pop()
            if cur in self.vertices:
                order.append(cur)
            for ch in children[cur]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    frontier.append(ch)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle or unreachable vertices: {sorted(cyc)}")
        return order

    def _infer(self):
        """Walk the DAG once: per-vertex input types (after preprocessors),
        automatically inserted preprocessors of layer vertices, and every
        vertex's output type."""
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import infer_preprocessor
        if len(self.input_types) != len(self.network_inputs):
            raise ValueError("input_types must be set for all network inputs")
        known: Dict[str, InputType] = dict(zip(self.network_inputs, self.input_types))
        types, pres = {}, {}
        for name in self.topological_order():
            obj, inputs = self.vertices[name]
            its = tuple(known[i] for i in inputs)
            if isinstance(obj, Layer):
                pre = infer_preprocessor(its[0], obj)
                if pre is not None:
                    pres[name] = pre
                    its = (pre.output_type(its[0]),) + its[1:]
                types[name] = its
                known[name] = obj.output_type(its[0])
            else:
                types[name] = its
                known[name] = obj.output_type(*its)
        return types, pres, known

    def vertex_input_types(self) -> Dict[str, Tuple[InputType, ...]]:
        return self._infer()[0]

    def resolved_vertex_preprocessors(self):
        return self._infer()[1]

    def vertex_output_types(self) -> Dict[str, InputType]:
        return self._infer()[2]

    def wired_vertices(self) -> Dict[str, Tuple[object, Tuple[str, ...]]]:
        types = self.vertex_input_types()
        out = {}
        for name, (obj, inputs) in self.vertices.items():
            if isinstance(obj, Layer):
                obj = obj.with_n_in(types[name][0].flat_size())
            out[name] = (obj, inputs)
        return out

    # ---- static analysis (analysis/validation.py) and memory (nn/memory.py)
    def validate(self, *, eval_shape_check: bool = False, batch: int = 2,
                 labels_shapes=None, raise_on_error: bool = True):
        """DAG validation before any parameter exists: cycles, dangling
        vertices, unknown references, merge and element-wise agreement, and
        per-layer shape inference with vertex-named messages.
        ``eval_shape_check=True`` also runs the forward on the ``meta``
        device. Returns the issues; raises
        ``analysis.ConfigValidationError`` on errors unless
        ``raise_on_error=False``."""
        from deeplearning4j_tpu_torch.analysis.validation import (ConfigValidationError,
                                                                  validate_graph)
        issues = validate_graph(self, eval_shape_check=eval_shape_check, batch=batch,
                                labels_shapes=labels_shapes)
        errors = [i for i in issues if i.severity == "error"]
        if errors and raise_on_error:
            raise ConfigValidationError(errors)
        return issues

    def memory_report(self, minibatch: int = 32):
        """Per-vertex parameter, activation and updater-state memory of
        this configuration, with no allocation (``nn/memory.py``)."""
        from deeplearning4j_tpu_torch.nn.memory import conf_memory_report
        return conf_memory_report(self, minibatch=minibatch)

    def fused(self) -> "ComputationGraphConfiguration":
        """Conv→BN→Act(→residual-add) fusion rewrite of this DAG
        (``perf/fusion.py``)."""
        from deeplearning4j_tpu_torch.perf.fusion import fuse
        return fuse(self)

    # ---- serde: the JAX package's schema ----
    def to_json(self) -> str:
        d = {
            "network_inputs": list(self.network_inputs),
            "network_outputs": list(self.network_outputs),
            "input_types": [t.to_dict() for t in self.input_types],
            "seed": self.seed,
            "dtype": self.dtype,
            "updater": self.updater.to_dict(),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "vertices": {
                name: {"node": (layer_to_dict(obj) if isinstance(obj, Layer)
                                else obj.to_dict()),
                       "is_layer": isinstance(obj, Layer),
                       "inputs": list(inputs)}
                for name, (obj, inputs) in self.vertices.items()
            },
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_from_dict
        d = json.loads(s)
        vertices = {}
        for name, vd in d["vertices"].items():
            node = vd["node"]
            if vd["is_layer"]:
                obj = layer_from_dict(node)
            elif node["@class"] == "PreprocessorVertex":
                obj = PreprocessorVertex(preprocessor_from_dict(node["preprocessor"]))
            else:
                obj = vertex_from_dict(node)
            vertices[name] = (obj, tuple(vd["inputs"]))
        return ComputationGraphConfiguration(
            network_inputs=tuple(d["network_inputs"]),
            vertices=vertices,
            network_outputs=tuple(d["network_outputs"]),
            input_types=tuple(InputType.from_dict(t) for t in d["input_types"]),
            seed=d.get("seed", 12345),
            dtype=d.get("dtype", "float32"),
            updater=Updater.from_dict(d["updater"]),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )


class GraphBuilder:
    """Fluent DAG builder (reference ComputationGraphConfiguration.GraphBuilder).
    ``parent`` is a ``NeuralNetConfiguration`` builder whose defaults the
    layers inherit."""

    def __init__(self, parent=None):
        self._parent = parent
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, Tuple[object, Tuple[str, ...]]] = {}
        self._input_types: List[InputType] = []
        self._backprop_type = "standard"
        self._tbptt_length = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        from deeplearning4j_tpu_torch.nn.conf.network import _apply_layer_defaults
        if self._parent is not None:
            layer = _apply_layer_defaults(layer, self._parent._defaults)
        self._vertices[name] = (layer, tuple(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        self._vertices[name] = (vertex, tuple(inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def backprop_type(self, kind: str, fwd_length: int = 20,
                      back_length: Optional[int] = None) -> "GraphBuilder":
        if kind not in ("standard", "tbptt"):
            raise ValueError(f"Unknown backprop_type '{kind}' "
                             "(expected 'standard' or 'tbptt')")
        if back_length is not None and back_length != fwd_length:
            raise ValueError(
                "tbptt back_length != fwd_length is not supported: got "
                f"fwd={fwd_length}, back={back_length}")
        self._backprop_type = kind
        self._tbptt_length = fwd_length
        return self

    def build(self) -> ComputationGraphConfiguration:
        p = self._parent
        conf = ComputationGraphConfiguration(
            network_inputs=tuple(self._inputs),
            vertices=dict(self._vertices),
            network_outputs=tuple(self._outputs),
            input_types=tuple(self._input_types),
            seed=p._seed if p else 12345,
            dtype=p._dtype if p else "float32",
            updater=p._updater if p else Sgd(learning_rate=0.1),
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_length,
            tbptt_back_length=self._tbptt_length,
        )
        conf.topological_order()  # validate the DAG early
        return conf
