"""Network memory reports (counterpart of ``deeplearning4j_tpu/nn/memory.py``;
reference ``nn/conf/memory/NetworkMemoryReport.java``,
``LayerMemoryReport.java``, ``MemoryReport.java``).

The per-layer table is the analytic view, row for row the JAX package's:
parameter counts and bytes, activation bytes and shapes from the
``InputType`` chain, and updater-state bytes counted as the JAX package
counts its optax states (slot trees, and a 4-byte step counter where optax
keeps one: the Adam family, and any learning-rate schedule). Parameter
shapes of a configuration come from each layer's init on the ``meta``
device, which allocates nothing, as ``jax.eval_shape`` does there.

The measured fields replace XLA's ``memory_analysis()`` of the compiled
step: for a network on a card, ``get_memory_report(compile_step=True)``
runs one train step of a copy of the network at zeros of the
``(minibatch, ...)`` input and reads the caching allocator:
``argument_bytes`` are the copy's parameters, state and updater state on
the device, ``peak_bytes`` the allocator's peak over the copy and its step
(allocations alive before the copy are not counted), and ``temp_bytes``
the peak less the arguments. ``output_bytes`` and
``generated_code_bytes`` stay 0 (an eager step has neither). On the CPU
``compiled`` is None, as the JAX report gives for a backend without memory
statistics. ``training_activation_bytes`` is the saved set of one
train-mode loss forward, measured on the meta device
(``perf/fusion.py::training_activation_bytes``); ``conf_memory_report(...,
training_bytes=False)`` skips it, as the planner does, and it is None
where the measurement does not apply (a configuration without a loss
layer).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.tree import tree_leaves

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}
_ADAM_FAMILY = ("Adam", "Nadam", "AdaMax")


@dataclasses.dataclass
class LayerMemoryReport:
    """Per-layer analytic memory (reference LayerMemoryReport.java)."""

    name: str
    layer_class: str
    num_params: int
    param_bytes: int
    # activation size for ONE example (bytes); multiply by minibatch
    activation_bytes_per_example: int
    activation_shape: tuple
    # the layer's remat= knob, when set (perf/fusion.py policies)
    remat: Optional[str] = None

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class MemoryReport:
    """Network-level report (reference NetworkMemoryReport.java)."""

    model_class: str
    minibatch: int
    dtype: str
    layers: List[LayerMemoryReport]
    total_param_bytes: int
    total_activation_bytes: int        # for the given minibatch
    updater_state_bytes: int
    # measured over one train step on the card (module docstring); None
    # when the step was skipped or the network is on the CPU
    compiled: Optional[dict] = None
    # the saved set of one train-mode loss forward (perf/fusion.py);
    # None when skipped or not measurable
    training_activation_bytes: Optional[int] = None
    # FusedConvBNActivation blocks in the configuration
    fused_blocks: int = 0

    def total_fixed_bytes(self) -> int:
        return self.total_param_bytes + self.updater_state_bytes

    def total_variable_bytes(self) -> int:
        return self.total_activation_bytes

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def to_string(self) -> str:
        lines = [
            f"Network memory report: {self.model_class} "
            f"(minibatch={self.minibatch}, dtype={self.dtype})",
            f"{'layer':<28}{'class':<26}{'params':>12}{'param MB':>10}"
            f"{'act KB/ex':>11}",
        ]
        for lr in self.layers:
            lines.append(
                f"{lr.name:<28}{lr.layer_class:<26}{lr.num_params:>12,}"
                f"{lr.param_bytes / 2**20:>10.2f}"
                f"{lr.activation_bytes_per_example / 2**10:>11.1f}"
                + (f"  remat={lr.remat}" if lr.remat else ""))
        lines.append(
            f"Totals: params {self.total_param_bytes / 2**20:.2f} MB, "
            f"updater state {self.updater_state_bytes / 2**20:.2f} MB, "
            f"activations {self.total_activation_bytes / 2**20:.2f} MB "
            f"@ minibatch {self.minibatch}")
        if self.compiled:
            c = self.compiled
            lines.append(
                "Measured train step (caching allocator): "
                f"arguments {c['argument_bytes'] / 2**20:.2f} MB, "
                f"temp {c['temp_bytes'] / 2**20:.2f} MB, "
                f"peak {c['peak_bytes'] / 2**20:.2f} MB")
        return "\n".join(lines)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _type_shape(it) -> tuple:
    """Per-example activation shape for an InputType (time axis of an
    unknown-length sequence counted as 1 step)."""
    if it.kind == "cnn":
        return (it.height, it.width, it.channels)
    if it.kind in ("rnn", "cnn1d"):
        return (it.timeseries_length or 1, it.size)
    return (it.flat_size(),)


def _input_type_bytes(it, itemsize: int):
    shape = _type_shape(it)
    return int(np.prod(shape)) * itemsize, shape


def _has_schedule(u) -> bool:
    """Whether optax keeps a schedule counter for this updater's learning
    rate (the JAX package lowers a constant rate to a float)."""
    policy = (u.lr_policy or "none").lower()
    if type(u).__name__ in ("AdaDelta", "NoOp") or policy == "none":
        return False
    return not (policy == "schedule" and not u.lr_schedule)


def _state_scalars(u) -> int:
    """Scalar leaves of the JAX package's optax state for updater ``u``."""
    if type(u).__name__ == "NoOp":
        return 0
    return int(type(u).__name__ in _ADAM_FAMILY) + int(_has_schedule(u))


def _updater_bytes(u, n_params: int, itemsize: int) -> int:
    """Updater-state bytes of one layer as the JAX package counts them."""
    return (len(u._slots) * n_params + _state_scalars(u)) * itemsize


def _fused_blocks(layers) -> int:
    return sum(1 for layer in layers if type(layer).__name__ == "FusedConvBNActivation")


def _entries(conf, input_type=None):
    """(conf, [(row name, layer, input type, updater)]) in the JAX
    package's order: a MultiLayerConfiguration's layers (``input_type``
    may override the configured one), a graph's layer vertices in
    topological order."""
    if hasattr(conf, "layers"):  # MultiLayerConfiguration
        if input_type is not None:
            conf = dataclasses.replace(conf, input_type=input_type)
        if conf.input_type is None:
            raise ValueError("memory_report requires an input_type")
        return conf, [(f"{i}_{type(layer).__name__}", layer, it,
                       getattr(src, "updater", None) or conf.updater)
                      for i, (layer, it, src) in enumerate(zip(
                          conf.wired_layers(), conf.layer_input_types(), conf.layers))]
    types = conf.vertex_input_types()
    wired = conf.wired_vertices()
    out = []
    for name in conf.topological_order():
        obj = wired[name][0]
        if hasattr(obj, "init"):  # Layer
            out.append((name, obj, types[name][0],
                        getattr(obj, "updater", None) or conf.updater))
    return conf, out


def _activation(layer, it, itemsize: int):
    try:
        out_t = layer.output_type(it)
    except ValueError:
        out_t = it
    return _input_type_bytes(out_t, itemsize)


def _training_bytes(conf, minibatch: int) -> Optional[int]:
    """``training_activation_bytes`` of ``conf``, None where the
    measurement does not apply (no loss layer, a label shape it cannot
    make)."""
    from deeplearning4j_tpu_torch.perf.fusion import training_activation_bytes
    try:
        return int(training_activation_bytes(conf, minibatch=minibatch))
    except Exception:
        return None


def conf_memory_report(conf, input_type=None, minibatch: int = 32,
                       training_bytes: bool = True) -> MemoryReport:
    """Memory report for a CONFIGURATION: no network, no device buffers.
    Per-layer parameter counts come from each layer's init on the ``meta``
    device; parameter, activation and updater-state bytes are counted at
    the configuration's dtype, as the JAX package counts them. Accepts a
    MultiLayerConfiguration (``input_type`` may override the configured
    one) or a ComputationGraphConfiguration. ``training_bytes=False`` skips
    the saved-set measurement (a meta-device forward of the whole network);
    the planner measures it itself."""
    from deeplearning4j_tpu_torch.analysis.validation import meta_init
    itemsize = _ITEMSIZE[conf.dtype]
    conf, entries = _entries(conf, input_type)
    reports: List[LayerMemoryReport] = []
    total_act = total_params = updater_bytes = 0
    for name, layer, it, upd in entries:
        p_meta, _ = meta_init(layer, it)
        n_params = sum(t.numel() for t in tree_leaves(p_meta))
        act_bytes, act_shape = _activation(layer, it, itemsize)
        reports.append(LayerMemoryReport(
            name=name, layer_class=type(layer).__name__, num_params=int(n_params),
            param_bytes=int(n_params * itemsize),
            activation_bytes_per_example=int(act_bytes), activation_shape=act_shape,
            remat=getattr(layer, "remat", None)))
        total_act += act_bytes * minibatch
        total_params += n_params * itemsize
        if n_params:
            updater_bytes += _updater_bytes(upd, n_params, itemsize)
    return MemoryReport(
        model_class=type(conf).__name__, minibatch=minibatch, dtype=conf.dtype,
        layers=reports, total_param_bytes=int(total_params),
        total_activation_bytes=int(total_act), updater_state_bytes=int(updater_bytes),
        compiled=None,
        training_activation_bytes=_training_bytes(conf, minibatch) if training_bytes else None,
        fused_blocks=_fused_blocks(layer for _, layer, _, _ in entries))


def get_memory_report(net, minibatch: int = 32, compile_step: bool = True) -> MemoryReport:
    """Memory report of an initialized network (reference
    MultiLayerConfiguration.getMemoryReport): the analytic table with the
    network's own parameter bytes (float32 masters) and updater state, and
    with ``compile_step=True`` on a card the measured step (module
    docstring). A ComputationGraph reports its layer vertices by name."""
    if net.params is None:
        net.init()
    if net.opt_state is None:
        net._reset_updaters()
    conf = net.conf
    itemsize = _ITEMSIZE[conf.dtype]
    _, entries = _entries(conf)
    keys = (list(range(len(entries))) if hasattr(conf, "layers")
            else [name for name, _, _, _ in entries])
    reports, total_act, updater_bytes = [], 0, 0
    for key, (name, layer, it, _) in zip(keys, entries):
        act_bytes, act_shape = _activation(layer, it, itemsize)
        reports.append(LayerMemoryReport(
            name=name, layer_class=type(layer).__name__,
            num_params=int(sum(t.numel() for t in tree_leaves(net.params[key]))),
            param_bytes=int(_tree_bytes(net.params[key])),
            activation_bytes_per_example=int(act_bytes), activation_shape=act_shape,
            remat=getattr(layer, "remat", None)))
        total_act += act_bytes * minibatch
    for key, u in (net._updaters.items() if isinstance(net._updaters, dict)
                   else enumerate(net._updaters)):
        state = net.opt_state[key]
        updater_bytes += (sum(_tree_bytes(state[s]) for s in u._slots)
                          + 4 * _state_scalars(u))
    compiled = None
    if compile_step and net.device.type == "cuda":
        compiled = _measured_step(net, minibatch)
    return MemoryReport(
        model_class=type(net).__name__, minibatch=minibatch, dtype=conf.dtype,
        layers=reports, total_param_bytes=int(_tree_bytes(net.params)),
        total_activation_bytes=int(total_act), updater_state_bytes=int(updater_bytes),
        compiled=compiled, training_activation_bytes=_training_bytes(conf, minibatch),
        fused_blocks=_fused_blocks(layer for _, layer, _, _ in entries))


def _zeros_batch(net, minibatch: int):
    """Zero features and labels of ``minibatch`` rows for every network
    input and output, on the network's device."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

    def features(it):
        shape = ((minibatch, it.flat_size()) if it.kind in ("ff", "cnn_flat")
                 else (minibatch,) + _type_shape(it))
        return torch.zeros(shape, dtype=torch.float32, device=net.device)

    def labels(layer, it):
        n_out = getattr(layer, "n_out", None) or 1
        if layer.output_type(it).kind in ("rnn", "cnn1d"):
            return torch.zeros((minibatch, it.timeseries_length or 1, n_out),
                               dtype=torch.float32, device=net.device)
        return torch.zeros((minibatch, n_out), dtype=torch.float32, device=net.device)

    conf = net.conf
    if hasattr(conf, "layers"):
        types = conf.layer_input_types()
        return DataSet(features(conf.input_type),
                       labels(net.layers[-1], types[-1]))
    vtypes = conf.vertex_input_types()
    return MultiDataSet([features(it) for it in conf.input_types],
                        [labels(net.vertices[o][0], vtypes[o][0])
                         for o in conf.network_outputs])


def _measured_step(net, minibatch: int) -> dict:
    """One train step of a copy of ``net`` between the allocator's peak
    reset and its reading (module docstring)."""
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    torch.cuda.synchronize(net.device)
    base = torch.cuda.memory_allocated(net.device)
    torch.cuda.reset_peak_memory_stats(net.device)
    copy = type(net)(net.conf, net.device)
    copy._seed_dropout()
    copy.set_params(tree_map(torch.clone, net.params), tree_map(torch.clone, net.state))
    argument = (_tree_bytes(copy.params) + _tree_bytes(copy.state)
                + _tree_bytes(copy.opt_state))
    copy._fit_batch(_zeros_batch(copy, minibatch))
    torch.cuda.synchronize(net.device)
    peak = torch.cuda.max_memory_allocated(net.device) - base
    del copy
    return {"argument_bytes": int(argument), "output_bytes": 0,
            "temp_bytes": int(max(peak - argument, 0)), "peak_bytes": int(peak),
            "generated_code_bytes": 0}
