"""Configuration validation: shape and type inference before any
parameter exists (counterpart of
``deeplearning4j_tpu/analysis/validation.py``).

A configuration mistake found inside the forward points at a tensor op,
not at the layer that caused it. This pass walks the ``InputType``
inference the configurations already use for wiring (``output_type`` per
layer and vertex) and captures each failure as a :class:`ValidationIssue`
that names the offending layer and both shapes, and adds the checks shape
inference alone does not make: unknown activations and losses, n_in
disagreement, arity and rank agreement on merge vertices, time-axis
consistency, dangling DAG nodes. Rules, messages, layer names and
severities are the JAX package's, word for word.

``eval_shape_check=True`` runs the network's own forward on the ``meta``
device (shapes and dtypes, no data, no allocation), the counterpart of
``jax.eval_shape``, and compares every layer's activation shape with the
pure-Python prediction, so the two cannot drift apart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "ValidationIssue", "ConfigValidationError",
    "validate_multilayer", "validate_graph",
]


@dataclasses.dataclass(frozen=True)
class ValidationIssue:
    """One finding. ``severity`` is 'error' (would fail or mis-train at
    runtime) or 'warning' (suspicious but runnable)."""

    rule: str
    layer: str          # display name of the offending layer/vertex
    message: str
    severity: str = "error"

    def __str__(self):
        return f"[{self.severity}] {self.rule} @ {self.layer}: {self.message}"


class ConfigValidationError(ValueError):
    """Raised by ``conf.validate()`` when error-severity issues exist."""

    def __init__(self, issues: Sequence[ValidationIssue]):
        self.issues = list(issues)
        super().__init__(
            "Invalid network configuration "
            f"({len(self.issues)} error{'s' if len(self.issues) != 1 else ''}):\n"
            + "\n".join(f"  - {i}" for i in self.issues))


def describe_type(it) -> str:
    """Human-readable InputType, used in every both-shapes message."""
    if it is None:
        return "<unknown>"
    if it.kind == "cnn":
        return f"cnn(h={it.height}, w={it.width}, c={it.channels})"
    if it.kind == "cnn_flat":
        return (f"cnn_flat(h={it.height}, w={it.width}, c={it.channels} -> "
                f"{it.flat_size()})")
    if it.kind in ("rnn", "cnn1d"):
        t = "?" if it.timeseries_length is None else it.timeseries_length
        return f"{it.kind}(t={t}, size={it.size})"
    return f"ff(size={it.size})"


def _layer_name(i: Optional[int], layer) -> str:
    cls = type(layer).__name__
    name = getattr(layer, "name", None)
    if name:
        return f"'{name}' ({cls})"
    if i is None:
        return cls
    return f"layer[{i}] ({cls})"


# layers where n_out == 0 is legal (width inferred from the input)
_N_OUT_OPTIONAL = ("TransformerEncoderBlock",)


def _check_layer(layer, cur, name: str) -> List[ValidationIssue]:
    """Static per-layer checks that do not need output_type to succeed.
    ``cur`` is the InputType the layer will see (post-preprocessor)."""
    from deeplearning4j_tpu_torch.nn.activations import ACTIVATIONS
    from deeplearning4j_tpu_torch.nn.lossfunctions import LOSSES

    issues: List[ValidationIssue] = []

    # unknown activation (catches typos before the first forward)
    for attr in ("activation", "ff_activation"):
        act = getattr(layer, attr, None)
        if act is not None and not callable(act) \
                and str(act).lower() not in ACTIVATIONS:
            issues.append(ValidationIssue(
                "unknown-activation", name,
                f"activation '{act}' is not a known activation "
                f"(known: {sorted(ACTIVATIONS)[:8]}...)"))

    # unknown loss on loss-bearing layers
    if layer.is_output_layer():
        loss = getattr(layer, "loss", None)
        if loss is not None and not callable(loss) \
                and str(loss).lower() not in LOSSES:
            issues.append(ValidationIssue(
                "unknown-loss", name,
                f"loss '{loss}' is not a known loss function "
                f"(known: {sorted(LOSSES)})"))

    # dropout is a retain probability (DL4J 0.9 semantics): [0, 1]
    dropout = getattr(layer, "dropout", None)
    if dropout is not None and not hasattr(dropout, "apply"):
        try:
            d = float(dropout)
        except (TypeError, ValueError):
            d = None
        if d is not None and not (0.0 <= d <= 1.0):
            issues.append(ValidationIssue(
                "dropout-range", name,
                f"dropout (retain probability) must be in [0, 1], got {d}"))

    # n_out required where the layer cannot infer its own width
    if hasattr(layer, "n_out") \
            and type(layer).__name__ not in _N_OUT_OPTIONAL:
        n_out = getattr(layer, "n_out")
        if not n_out or n_out < 0:
            issues.append(ValidationIssue(
                "n-out-missing", name,
                f"n_out must be a positive integer, got {n_out!r}"))

    # explicit n_in that disagrees with the inferred input size (stale
    # hand-wiring, e.g. after editing an upstream layer's width)
    target = layer
    for _ in range(3):  # unwrap Bidirectional/LastTimeStep-style wrappers
        n_in = getattr(target, "n_in", None)
        if n_in and cur is not None:
            kind = target.input_kind() if hasattr(target, "input_kind") else "any"
            if kind == "cnn" and cur.kind == "cnn":
                expected = cur.channels
                what = f"input channels ({describe_type(cur)})"
            else:
                expected = cur.flat_size()
                what = f"input size ({describe_type(cur)})"
            if int(n_in) != int(expected):
                issues.append(ValidationIssue(
                    "n-in-mismatch", name,
                    f"explicit n_in={n_in} disagrees with the {what} "
                    f"= {expected}"))
        inner = getattr(target, "layer", None)
        if inner is None:
            break
        target = inner

    # unknown remat policy (a typo would otherwise surface in the first
    # training forward)
    remat = getattr(layer, "remat", None)
    if remat is not None:
        from deeplearning4j_tpu_torch.perf.fusion import REMAT_POLICIES
        if str(remat) not in REMAT_POLICIES:
            issues.append(ValidationIssue(
                "unknown-remat", name,
                f"remat='{remat}' is not a known rematerialization policy "
                f"(known: {sorted(REMAT_POLICIES)})"))

    # sequence layers need a time axis to operate on
    if hasattr(layer, "input_kind") and layer.input_kind() == "rnn" \
            and cur is not None and cur.kind not in ("rnn", "cnn1d"):
        issues.append(ValidationIssue(
            "time-axis", name,
            f"sequence layer fed non-sequence input {describe_type(cur)}; "
            "use InputType.recurrent(...) or insert a "
            "FeedForwardToRnnPreProcessor"))

    # known-incoherent loss/activation pairings (mis-trains silently)
    if layer.is_output_layer():
        loss = str(getattr(layer, "loss", "") or "").lower()
        act = str(getattr(layer, "activation", "") or "").lower()
        if loss == "mcxent" and act in ("identity", "relu", "sigmoid"):
            issues.append(ValidationIssue(
                "loss-activation", name,
                f"loss 'mcxent' expects a softmax output, got activation "
                f"'{act}' (multi-class cross-entropy over non-normalized "
                "outputs trains incorrectly)", severity="warning"))
        if loss == "xent" and act == "softmax":
            issues.append(ValidationIssue(
                "loss-activation", name,
                "loss 'xent' (binary cross-entropy) with softmax activation "
                "— use 'mcxent' for multi-class softmax outputs",
                severity="warning"))

    return issues


def _labels_shape_issue(out_layer, final_type, labels_shape,
                        name: str) -> Optional[ValidationIssue]:
    """Loss-vs-label shape compatibility for a concrete labels shape."""
    n_out = getattr(out_layer, "n_out", None) or final_type.flat_size()
    ls = tuple(int(d) for d in labels_shape)
    if final_type.kind in ("rnn", "cnn1d"):
        ok = len(ls) == 3 and ls[-1] == n_out
        expected = f"(batch, time, {n_out})"
    else:
        ok = len(ls) == 2 and ls[-1] == n_out
        expected = f"(batch, {n_out})"
    if ok:
        return None
    return ValidationIssue(
        "labels-shape", name,
        f"labels shape {ls} is incompatible with the output layer "
        f"(n_out={n_out}, output {describe_type(final_type)}): "
        f"expected {expected}")


# --------------------------------------------------------------- multilayer
def validate_multilayer(conf, *, eval_shape_check: bool = False,
                        batch: int = 2,
                        labels_shape=None) -> List[ValidationIssue]:
    """Validate a MultiLayerConfiguration. Returns every issue found (an
    empty list means clean); ``conf.validate()`` raises
    :class:`ConfigValidationError` on errors."""
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import infer_preprocessor

    issues: List[ValidationIssue] = []
    if not conf.layers:
        return [ValidationIssue("empty-network", "<network>",
                                "configuration has no layers")]
    if conf.input_type is None:
        return [ValidationIssue(
            "missing-input-type", "<network>",
            "input_type is required for shape inference "
            "(.set_input_type(InputType...) on the builder)")]

    cur = conf.input_type
    types = []          # InputType seen by each layer, post-preprocessor
    inference_ok = True
    for i, layer in enumerate(conf.layers):
        name = _layer_name(i, layer)
        pre = (conf.input_preprocessors or {}).get(i)
        try:
            if pre is None:
                pre = infer_preprocessor(cur, layer)
        except ValueError as e:
            issues.append(ValidationIssue(
                "preprocessor", name,
                f"{e} (input {describe_type(cur)})"))
            inference_ok = False
            break
        if pre is not None:
            cur = pre.output_type(cur)
        types.append(cur)
        issues.extend(_check_layer(layer, cur, name))
        if layer.is_output_layer() and i != len(conf.layers) - 1:
            issues.append(ValidationIssue(
                "output-layer-position", name,
                f"output/loss layer at position {i} of "
                f"{len(conf.layers)}; only the last layer may carry a loss"))
        try:
            cur = layer.output_type(cur)
        except ValueError as e:
            issues.append(ValidationIssue(
                "geometry", name,
                f"{e} (input {describe_type(types[-1])})"))
            inference_ok = False
            break

    last = conf.layers[-1]
    if not last.is_output_layer():
        issues.append(ValidationIssue(
            "no-output-layer", _layer_name(len(conf.layers) - 1, last),
            "last layer is not an output/loss layer: fit() will refuse this "
            "network (inference-only use is fine)", severity="warning"))

    if conf.backprop_type == "tbptt" \
            and not any(l.is_recurrent() for l in conf.layers):
        issues.append(ValidationIssue(
            "tbptt-without-rnn", "<network>",
            "backprop_type='tbptt' but no layer is recurrent; truncated "
            "BPTT windows will never apply", severity="warning"))

    if inference_ok and labels_shape is not None and last.is_output_layer():
        li = _labels_shape_issue(last, cur, labels_shape,
                                 _layer_name(len(conf.layers) - 1, last))
        if li is not None:
            issues.append(li)

    if inference_ok and eval_shape_check \
            and not any(i.severity == "error" for i in issues):
        issues.extend(_eval_shape_check_multilayer(conf, batch))
    return issues


# -------------------------------------------------------------------- graph
def _vertex_arity_issue(obj, in_names, name) -> Optional[ValidationIssue]:
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ElementWiseVertex, L2Vertex,
    )
    if isinstance(obj, L2Vertex) and len(in_names) != 2:
        return ValidationIssue(
            "vertex-arity", name,
            f"L2Vertex requires exactly 2 inputs, got {len(in_names)}")
    if isinstance(obj, ElementWiseVertex):
        if obj.op.lower() == "subtract" and len(in_names) != 2:
            return ValidationIssue(
                "vertex-arity", name,
                f"ElementWiseVertex(op='subtract') requires exactly 2 "
                f"inputs, got {len(in_names)}")
        if len(in_names) < 2:
            return ValidationIssue(
                "vertex-arity", name,
                f"ElementWiseVertex needs >= 2 inputs, got {len(in_names)}")
    return None


def _merge_agreement_issues(obj, its, in_names, name) -> List[ValidationIssue]:
    """Rank + shape agreement for multi-input combiner vertices, with both
    shapes in the message."""
    from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex
    issues: List[ValidationIssue] = []
    if len(its) < 2:
        return issues
    shapes = ", ".join(f"{n}={describe_type(t)}"
                       for n, t in zip(in_names, its))
    if isinstance(obj, (MergeVertex, ElementWiseVertex)):
        kinds = {t.kind for t in its}
        if len(kinds) > 1:
            issues.append(ValidationIssue(
                "merge-rank-mismatch", name,
                f"inputs have different ranks/families {sorted(kinds)}: "
                f"{shapes}"))
            return issues
        base = its[0]
        if isinstance(obj, ElementWiseVertex):
            # element-wise needs every dim equal (feature axis included)
            if any(t != base for t in its[1:]):
                issues.append(ValidationIssue(
                    "elementwise-mismatch", name,
                    f"element-wise '{obj.op}' needs identical input shapes: "
                    f"{shapes}"))
        else:  # MergeVertex concatenates features: non-feature dims agree
            if base.kind == "cnn" and any(
                    (t.height, t.width) != (base.height, base.width)
                    for t in its[1:]):
                issues.append(ValidationIssue(
                    "merge-mismatch", name,
                    f"merge needs equal spatial dims: {shapes}"))
            if base.kind in ("rnn", "cnn1d"):
                ts = {t.timeseries_length for t in its
                      if t.timeseries_length is not None}
                if len(ts) > 1:
                    issues.append(ValidationIssue(
                        "merge-mismatch", name,
                        f"merge needs equal sequence lengths: {shapes}"))
    return issues


def validate_graph(conf, *, eval_shape_check: bool = False,
                   batch: int = 2,
                   labels_shapes=None) -> List[ValidationIssue]:
    """Validate a ComputationGraphConfiguration DAG."""
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        DuplicateToTimeSeriesVertex, LastTimeStepVertex,
    )
    from deeplearning4j_tpu_torch.nn.conf.layers import Layer
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import infer_preprocessor

    issues: List[ValidationIssue] = []
    known_names = set(conf.network_inputs) | set(conf.vertices)

    if len(conf.input_types) != len(conf.network_inputs):
        issues.append(ValidationIssue(
            "missing-input-type", "<network>",
            f"{len(conf.network_inputs)} network inputs but "
            f"{len(conf.input_types)} input_types; every input needs a "
            "declared InputType"))
        return issues

    for ni in conf.network_inputs:
        if ni in conf.vertices:
            issues.append(ValidationIssue(
                "name-collision", f"'{ni}'",
                "name is both a network input and a vertex"))

    # unknown input references (named per vertex)
    structurally_ok = True
    for name, (obj, in_names) in conf.vertices.items():
        if not in_names:
            issues.append(ValidationIssue(
                "vertex-no-inputs", f"'{name}'",
                f"vertex '{name}' has no inputs"))
            structurally_ok = False
        for i in in_names:
            if i not in known_names:
                issues.append(ValidationIssue(
                    "unknown-input", f"'{name}'",
                    f"vertex '{name}' references unknown input '{i}' "
                    f"(known: network inputs {list(conf.network_inputs)}, "
                    f"vertices {sorted(conf.vertices)})"))
                structurally_ok = False
        ai = _vertex_arity_issue(obj, in_names, f"'{name}'")
        if ai is not None:
            issues.append(ai)

    for out in conf.network_outputs:
        if out not in conf.vertices:
            issues.append(ValidationIssue(
                "unknown-output", f"'{out}'",
                f"network output '{out}' is not a vertex"))
            structurally_ok = False
        else:
            obj = conf.vertices[out][0]
            if not (isinstance(obj, Layer) and obj.is_output_layer()):
                issues.append(ValidationIssue(
                    "output-not-loss", f"'{out}'",
                    f"network output '{out}' ({type(obj).__name__}) is not "
                    "an output/loss layer"))

    if not structurally_ok:
        return issues  # topology below would mis-report on broken references

    # cycle / unreachable detection (Kahn's algorithm, mirrored from
    # topological_order but capturing the leftover set instead of raising)
    indeg = {n: len(ins) for n, (_, ins) in conf.vertices.items()}
    children: Dict[str, List[str]] = {n: [] for n in known_names}
    for name, (_, in_names) in conf.vertices.items():
        for i in in_names:
            children[i].append(name)
    order: List[str] = []
    frontier = list(conf.network_inputs)
    while frontier:
        cur = frontier.pop()
        if cur in conf.vertices:
            order.append(cur)
        for ch in children[cur]:
            indeg[ch] -= 1
            if indeg[ch] == 0:
                frontier.append(ch)
    leftover = set(conf.vertices) - set(order)
    if leftover:
        # every leftover vertex is on a cycle or downstream of one (a
        # no-input or dangling-reference island was already rejected
        # above). Peel vertices with no successor inside the leftover set
        # until fixpoint: what remains is the cycle core, the peeled rest
        # merely depends on it.
        core = set(leftover)
        while True:
            downstream_free = {
                n for n in core
                if not any(n in conf.vertices[ch][1]  # ch==n: self-loop
                           for ch in core)}
            if not downstream_free:
                break
            core -= downstream_free
        cyclic = sorted(core) if core else sorted(leftover)
        issues.append(ValidationIssue(
            "cycle", f"'{cyclic[0]}'",
            f"graph has a cycle through vertices {cyclic}"))
        downstream = sorted(leftover - core)
        if core and downstream:
            issues.append(ValidationIssue(
                "cycle-downstream", f"'{downstream[0]}'",
                f"vertices {downstream} can never evaluate: they depend "
                f"on the cycle through {cyclic}"))
        return issues

    # dangling vertices: output feeds nothing and is not a network output
    consumed = {i for _, (_, ins) in conf.vertices.items() for i in ins}
    for name in conf.vertices:
        if name not in consumed and name not in conf.network_outputs:
            issues.append(ValidationIssue(
                "dangling-vertex", f"'{name}'",
                f"vertex '{name}' is consumed by nothing and is not a "
                "network output (dead subgraph)", severity="warning"))

    # shape inference over the DAG, capturing per-vertex failures
    known: Dict[str, object] = dict(zip(conf.network_inputs,
                                        conf.input_types))
    inference_ok = True
    final_types: Dict[str, object] = {}
    for name in order:
        obj, in_names = conf.vertices[name]
        its = tuple(known[i] for i in in_names)
        disp = f"'{name}'"
        if isinstance(obj, Layer):
            cur = its[0]
            try:
                pre = infer_preprocessor(cur, obj)
            except ValueError as e:
                issues.append(ValidationIssue(
                    "preprocessor", disp,
                    f"{e} (input {describe_type(cur)})"))
                inference_ok = False
                break
            if pre is not None:
                cur = pre.output_type(cur)
            issues.extend(_check_layer(obj, cur, disp))
            try:
                known[name] = obj.output_type(cur)
            except ValueError as e:
                issues.append(ValidationIssue(
                    "geometry", disp,
                    f"{e} (input {describe_type(cur)})"))
                inference_ok = False
                break
        else:
            issues.extend(_merge_agreement_issues(obj, its, in_names, disp))
            if isinstance(obj, LastTimeStepVertex) \
                    and its[0].kind not in ("rnn", "cnn1d"):
                issues.append(ValidationIssue(
                    "time-axis", disp,
                    f"LastTimeStepVertex needs sequence input, got "
                    f"{describe_type(its[0])}"))
            if isinstance(obj, DuplicateToTimeSeriesVertex) \
                    and obj.reference_input is not None \
                    and obj.reference_input not in known_names:
                issues.append(ValidationIssue(
                    "unknown-input", disp,
                    f"reference_input '{obj.reference_input}' is not a "
                    "known vertex or network input"))
            if any(i.severity == "error" and i.layer == disp
                   for i in issues):
                inference_ok = False
                break
            try:
                known[name] = obj.output_type(*its)
            except (ValueError, IndexError, AttributeError) as e:
                issues.append(ValidationIssue(
                    "shape-inference", disp,
                    f"{type(obj).__name__}.output_type failed: {e} "
                    f"(inputs {[describe_type(t) for t in its]})"))
                inference_ok = False
                break
        final_types[name] = known[name]

    if inference_ok and labels_shapes is not None:
        for out, ls in zip(conf.network_outputs, labels_shapes):
            obj = conf.vertices[out][0]
            li = _labels_shape_issue(obj, final_types[out], ls, f"'{out}'")
            if li is not None:
                issues.append(li)

    if inference_ok and eval_shape_check \
            and not any(i.severity == "error" for i in issues):
        issues.extend(_eval_shape_check_graph(conf, batch))
    return issues


# --------------------------------------------- forward on the meta device
_DEFAULT_T = 16  # time length used when the configuration leaves it unknown
_META = torch.device("meta")


def _input_struct(it, batch: int, index_input: bool) -> torch.Tensor:
    """A meta tensor for one network input of the given InputType."""
    if index_input:
        t = (it.timeseries_length or _DEFAULT_T) if it.kind in ("rnn", "cnn1d") else 1
        return torch.empty((batch, t), dtype=torch.float32, device=_META)
    if it.kind in ("rnn", "cnn1d"):
        t = it.timeseries_length or _DEFAULT_T
        return torch.empty((batch, t, it.size), dtype=torch.float32, device=_META)
    if it.kind == "cnn":
        return torch.empty((batch, it.height, it.width, it.channels), dtype=torch.float32,
                           device=_META)
    return torch.empty((batch, it.flat_size()), dtype=torch.float32, device=_META)


def _shape_agrees(predicted, actual: Tuple[int, ...]) -> bool:
    """Does an activation shape match the InputType prediction? Batch dims
    are never compared (preprocessors legally fold time into batch);
    unknown sequence lengths (None) match anything."""
    if predicted.kind in ("ff", "cnn_flat"):
        return len(actual) == 2 and actual[-1] == predicted.flat_size()
    if predicted.kind in ("rnn", "cnn1d"):
        if len(actual) != 3 or actual[-1] != predicted.size:
            return False
        t = predicted.timeseries_length
        return t is None or actual[1] == t
    if predicted.kind == "cnn":
        return (len(actual) == 4 and tuple(actual[1:]) ==
                (predicted.height, predicted.width, predicted.channels))
    return True


def meta_init(layer, it):
    """A layer's parameter and state tensors on the ``meta`` device: their
    shapes and dtypes, nothing allocated (the draws come from a CPU
    generator, which the meta device accepts and ignores)."""
    return layer.init(torch.Generator(), it, _META)


def _is_index_layer(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.conf.recurrent import EmbeddingLayer
    return (getattr(layer, "takes_index_sequence", False)
            or isinstance(layer, EmbeddingLayer))


def _meta_net(cls, conf):
    """A network of ``cls`` whose device is ``meta`` (built on the CPU,
    which allocates nothing, then moved by name)."""
    net = cls(conf, device="cpu")
    net.device = _META
    return net


def _eval_shape_check_multilayer(conf, batch: int) -> List[ValidationIssue]:
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    issues: List[ValidationIssue] = []
    net = _meta_net(MultiLayerNetwork, conf)
    types = conf.layer_input_types()
    params, state = [], []
    for layer, it in zip(net.layers, types):
        p, s = meta_init(layer, it)
        params.append(p)
        state.append(s)
    first = net.layers[0]
    if _is_index_layer(first) and not getattr(first, "takes_index_sequence", False):
        x = torch.empty((batch, 1), dtype=torch.float32, device=_META)  # EmbeddingLayer ids
    else:
        x = _input_struct(conf.input_type, batch, _is_index_layer(first))
    try:
        with torch.no_grad():
            acts = net._forward(params, state, x, False)[0]
    except Exception as e:  # inference said OK but the forward disagrees
        return [ValidationIssue(
            "eval-shape-trace", "<network>",
            f"the meta-device forward pass failed although shape "
            f"inference passed: {type(e).__name__}: {e}")]
    for i, (layer, it) in enumerate(zip(net.layers, types)):
        predicted = layer.output_type(it)
        actual = tuple(acts[i].shape)
        if not _shape_agrees(predicted, actual):
            issues.append(ValidationIssue(
                "eval-shape-drift", _layer_name(i, layer),
                f"shape inference predicts {describe_type(predicted)} but "
                f"the meta-device forward gives activation shape {actual}"))
    return issues


def _eval_shape_check_graph(conf, batch: int) -> List[ValidationIssue]:
    from deeplearning4j_tpu_torch.nn.conf.layers import Layer
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    issues: List[ValidationIssue] = []
    try:
        net = _meta_net(ComputationGraph, conf)
    except ValueError as e:
        return [ValidationIssue("graph-construction", "<network>", str(e))]
    params, state = {}, {}
    for name in net.order:
        obj, _ = net.vertices[name]
        if isinstance(obj, Layer):
            params[name], state[name] = meta_init(obj, net.vertex_input_types[name][0])
        else:
            params[name], state[name] = {}, {}
    # an input is an index sequence when any direct consumer embeds ids
    inputs = []
    for ni, it in zip(conf.network_inputs, conf.input_types):
        consumers = [conf.vertices[n][0] for n, (_, ins) in conf.vertices.items() if ni in ins]
        idx = any(isinstance(c, Layer) and _is_index_layer(c) for c in consumers)
        inputs.append(_input_struct(it, batch, idx))
    try:
        with torch.no_grad():
            acts = net._forward(params, state, inputs, False)[0]
    except Exception as e:
        return [ValidationIssue(
            "eval-shape-trace", "<network>",
            f"the meta-device graph forward failed although shape "
            f"inference passed: {type(e).__name__}: {e}")]
    predicted_types = conf.vertex_output_types()
    for name in net.order:
        predicted = predicted_types[name]
        actual = tuple(acts[name].shape)
        if not _shape_agrees(predicted, actual):
            issues.append(ValidationIssue(
                "eval-shape-drift", f"'{name}'",
                f"shape inference predicts {describe_type(predicted)} but "
                f"the meta-device forward gives activation shape {actual}"))
    return issues
