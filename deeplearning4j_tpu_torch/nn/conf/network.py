"""Network configuration: global defaults + MultiLayerConfiguration
(counterpart of ``deeplearning4j_tpu/nn/conf/network.py``).

``MultiLayerConfiguration.to_json``/``from_json`` use the JAX package's
schema key for key, so the port reads the JSON the JAX package writes and
writes JSON the JAX package reads. Updaters are the port's own
``optimize.updaters`` objects, written and read in the JAX package's
``Updater.to_dict()`` form.

Builder defaults work as in the JAX package: a layer field still equal to
its dataclass default is "unset" and inherits the builder's value.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

# every layer family registers its classes when imported: from_json must
# find them wherever it is called from
from deeplearning4j_tpu_torch.nn.conf import (attention, convolutional,  # noqa: F401
                                              normalization, objdetect, pooling, pretrain,
                                              recurrent, regularization, variational)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    infer_preprocessor, preprocessor_from_dict, preprocessor_to_dict)
from deeplearning4j_tpu_torch.optimize.updaters import Sgd, Updater


def _apply_layer_defaults(layer: Layer, defaults: dict) -> Layer:
    field_map = {f.name: f for f in dataclasses.fields(layer)}
    updates = {}
    for k, v in defaults.items():
        if k not in field_map or v is None:
            continue
        f = field_map[k]
        default_val = f.default if f.default is not dataclasses.MISSING else None
        if getattr(layer, k) == default_val:
            updates[k] = v
    return dataclasses.replace(layer, **updates) if updates else layer


@dataclasses.dataclass(frozen=True)
class MultiLayerConfiguration:
    """Immutable, JSON-round-trippable network config."""

    layers: Tuple[Layer, ...]
    input_type: Optional[InputType] = None
    seed: int = 12345
    dtype: str = "float32"
    updater: Updater = Sgd(learning_rate=0.1)
    optimization_algo: str = "stochastic_gradient_descent"
    backprop_type: str = "standard"  # "standard" | "tbptt"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    # per-layer-index input preprocessors
    input_preprocessors: Optional[Dict[int, object]] = None

    def __post_init__(self):
        if (self.backprop_type == "tbptt"
                and self.tbptt_fwd_length != self.tbptt_back_length):
            raise ValueError(
                "tbptt_back_length != tbptt_fwd_length is not supported: got "
                f"fwd={self.tbptt_fwd_length}, back={self.tbptt_back_length}. "
                "Use equal lengths")

    def _walk(self):
        """(layer, preprocessor or None, input type seen by the layer)."""
        if self.input_type is None:
            raise ValueError("MultiLayerConfiguration requires input_type for shape inference")
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            pre = (self.input_preprocessors or {}).get(i)
            if pre is None:
                pre = infer_preprocessor(cur, layer)
            if pre is not None:
                cur = pre.output_type(cur)
            yield layer, pre, cur
            cur = layer.output_type(cur)

    def layer_input_types(self) -> List[InputType]:
        """Input type *seen by each layer* after preprocessor insertion."""
        return [t for _, _, t in self._walk()]

    def wired_layers(self) -> Tuple[Layer, ...]:
        """Layers with n_in filled from shape inference."""
        return tuple(l.with_n_in(t.flat_size()) for l, _, t in self._walk())

    def resolved_preprocessors(self) -> Dict[int, object]:
        return {i: pre for i, (_, pre, _) in enumerate(self._walk())
                if pre is not None}

    # ---- static analysis (analysis/validation.py) and memory (nn/memory.py)
    def validate(self, *, eval_shape_check: bool = False, batch: int = 2,
                 labels_shape=None, raise_on_error: bool = True):
        """Shape and type inference over the layer stack before any
        parameter exists, with layer-named messages (conv geometry, n_in /
        n_out wiring, unknown activations and losses, time-axis
        consistency, loss against labels). ``eval_shape_check=True`` also
        runs the forward on the ``meta`` device and holds every layer's
        shape to the prediction. Returns the issues (warnings included);
        raises ``analysis.ConfigValidationError`` on errors unless
        ``raise_on_error=False``."""
        from deeplearning4j_tpu_torch.analysis.validation import (ConfigValidationError,
                                                                  validate_multilayer)
        issues = validate_multilayer(self, eval_shape_check=eval_shape_check, batch=batch,
                                     labels_shape=labels_shape)
        errors = [i for i in issues if i.severity == "error"]
        if errors and raise_on_error:
            raise ConfigValidationError(errors)
        return issues

    def memory_report(self, input_type=None, minibatch: int = 32):
        """Per-layer parameter, activation and updater-state memory of this
        configuration, with no allocation (``nn/memory.py``)."""
        from deeplearning4j_tpu_torch.nn.memory import conf_memory_report
        return conf_memory_report(self, input_type=input_type, minibatch=minibatch)

    def fused(self) -> "MultiLayerConfiguration":
        """Conv→BN→Act fusion rewrite of this configuration
        (``perf/fusion.py``)."""
        from deeplearning4j_tpu_torch.perf.fusion import fuse
        return fuse(self)

    # ---- serde: the JAX package's schema ----
    def to_json(self) -> str:
        d = {
            "layers": [l.to_dict() for l in self.layers],
            "seed": self.seed,
            "dtype": self.dtype,
            "updater": self.updater.to_dict(),
            "optimization_algo": self.optimization_algo,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }
        if self.input_type is not None:
            d["input_type"] = self.input_type.to_dict()
        if self.input_preprocessors:
            d["input_preprocessors"] = {
                str(k): preprocessor_to_dict(v) for k, v in self.input_preprocessors.items()}
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        pre = None
        if "input_preprocessors" in d:
            pre = {int(k): preprocessor_from_dict(v)
                   for k, v in d["input_preprocessors"].items()}
        return MultiLayerConfiguration(
            layers=tuple(layer_from_dict(ld) for ld in d["layers"]),
            input_type=InputType.from_dict(d["input_type"]) if "input_type" in d else None,
            seed=d.get("seed", 12345),
            dtype=d.get("dtype", "float32"),
            updater=Updater.from_dict(d["updater"]),
            optimization_algo=d.get("optimization_algo",
                                    "stochastic_gradient_descent"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_preprocessors=pre,
        )


class NeuralNetConfiguration:
    """Fluent builder entry point (reference NeuralNetConfiguration.Builder)."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._defaults: dict = {}
        self._seed = 12345
        self._dtype = "float32"
        self._updater: Updater = Sgd(learning_rate=0.1)

    def seed(self, s: int) -> "Builder":
        self._seed = int(s)
        return self

    def dtype(self, dt: str) -> "Builder":
        self._dtype = dt
        return self

    def updater(self, u: Updater) -> "Builder":
        """``u`` is an ``optimize.updaters`` object (``Adam(1e-3)``)."""
        if not isinstance(u, Updater):
            raise TypeError(f"updater(...) takes an Updater object; got "
                            f"{type(u).__name__}")
        self._updater = u
        self._defaults["updater"] = u
        return self

    def weight_init(self, wi: str, dist=None) -> "Builder":
        self._defaults["weight_init"] = wi
        if dist is not None:
            self._defaults["dist"] = dist
        return self

    def activation(self, a: str) -> "Builder":
        self._defaults["activation"] = a
        return self

    def l1(self, v: float) -> "Builder":
        self._defaults["l1"] = v
        return self

    def l2(self, v: float) -> "Builder":
        self._defaults["l2"] = v
        return self

    def dropout(self, keep_prob: float) -> "Builder":
        self._defaults["dropout"] = keep_prob
        return self

    def bias_init(self, v: float) -> "Builder":
        self._defaults["bias_init"] = v
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self)


class ListBuilder:
    def __init__(self, parent: Builder):
        self._parent = parent
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._preprocessors: Dict[int, object] = {}
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._optimization_algo = "stochastic_gradient_descent"

    def optimization_algo(self, algo: str) -> "ListBuilder":
        """reference NeuralNetConfiguration.Builder.optimizationAlgo:
        "stochastic_gradient_descent", or a full-batch solver ("lbfgs",
        "conjugate_gradient", "line_gradient_descent")."""
        self._optimization_algo = algo.lower()
        return self

    def layer(self, conf: Layer) -> "ListBuilder":
        self._layers.append(_apply_layer_defaults(conf, self._parent._defaults))
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def input_preprocessor(self, idx: int, pre) -> "ListBuilder":
        self._preprocessors[idx] = pre
        return self

    def backprop_type(self, t: str, fwd_length: int = 20,
                      back_length: int = 20) -> "ListBuilder":
        """"standard" or "tbptt" with its window lengths (equal lengths are
        checked by MultiLayerConfiguration)."""
        self._backprop_type = t
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length
        return self

    def build(self) -> MultiLayerConfiguration:
        return MultiLayerConfiguration(
            layers=tuple(self._layers),
            input_type=self._input_type,
            seed=self._parent._seed,
            dtype=self._parent._dtype,
            updater=self._parent._updater,
            optimization_algo=self._optimization_algo,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_preprocessors=self._preprocessors or None,
        )
