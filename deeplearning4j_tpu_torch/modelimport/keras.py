"""Keras HDF5 model import (counterpart of
``deeplearning4j_tpu/modelimport/keras.py``: the same configurations,
conversions and checks).

Parity surface: reference ``keras/KerasModelImport.java:41,:50-174`` (public
API), ``keras/KerasModel.java`` / ``KerasSequentialModel.java`` (config
parsing, topology, weight copy). Supports Keras 2.x and Keras 3 legacy-H5
files (full model .h5 with ``model_config`` attribute + ``model_weights``
group, or config JSON + weights-only .h5).

Import produces a fully initialized network; weights are validated
shape-by-shape against the initialized params before being copied in, as
float32 tensors on the network's device. Every entry point takes
``device=`` and follows the port's device rule (``cuda`` unless the caller
passes ``device="cpu"``). Where the JAX package takes a path, the port also
takes an opened archive: any object with ``Hdf5Archive``'s read surface
(``has_attribute``, ``read_attribute_as_json`` / ``_as_string`` /
``_as_string_list``, ``read_dataset``, ``get_groups``, ``has_group``,
``walk_datasets``, or ``layer_weights`` as ``KerasV3Archive`` has), which
the caller keeps and closes: a host without h5py imports a model it holds
in memory that way.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.hdf5 import (Hdf5Archive,
                                                       open_model_archive)
from deeplearning4j_tpu_torch.modelimport.keras_layers import (
    KerasImportError, KerasLayerSpec, convert_layer, map_loss,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer, Layer
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration, GraphVertex,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

_LOSS_CLASS_MAP = {
    "CategoricalCrossentropy": "mcxent",
    "SparseCategoricalCrossentropy": "mcxent",
    "BinaryCrossentropy": "xent",
    "MeanSquaredError": "mse",
    "MeanAbsoluteError": "mae",
    "KLDivergence": "kld",
    "Poisson": "poisson",
    "Hinge": "hinge",
    "SquaredHinge": "squared_hinge",
}


# ------------------------------------------------------------------ helpers
def _open(source):
    """(archive, owned): a path opened here (closed by the caller of
    ``_open``), or an archive object passed in (left to its owner)."""
    if source is None:
        return None, False
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        return open_model_archive(source), True
    return source, False


def _model_config(archive: Hdf5Archive, model_json: Optional[str]) -> dict:
    if model_json is not None:
        return json.loads(model_json)
    if archive is None or not archive.has_attribute("model_config"):
        raise KerasImportError(
            "No model_config attribute in HDF5 file and no JSON config given "
            "(reference KerasModelImport requires one of the two)")
    return archive.read_attribute_as_json("model_config")


def _training_loss(archive: Optional[Hdf5Archive]) -> Optional[str]:
    if archive is None or not archive.has_attribute("training_config"):
        return None
    tc = archive.read_attribute_as_json("training_config")
    loss = tc.get("loss")
    if loss is None:
        return None
    if isinstance(loss, dict):
        # Keras 3 serialized loss object, or per-output dict
        cn = loss.get("class_name")
        if cn in _LOSS_CLASS_MAP:
            return _LOSS_CLASS_MAP[cn]
        if cn is not None:
            return None
        loss = next(iter(loss.values()))
    if isinstance(loss, str):
        if loss in _LOSS_CLASS_MAP:
            return _LOSS_CLASS_MAP[loss]
        try:
            return map_loss(loss)
        except KerasImportError:
            return None
    return None


def _import_ctx(archive: Optional[Hdf5Archive], config: dict) -> dict:
    ctx = {"keras_version": "2", "backend": "tensorflow", "dim_ordering": "tf"}
    if archive is not None:
        if archive.has_attribute("keras_version"):
            ctx["keras_version"] = archive.read_attribute_as_string("keras_version")
        if archive.has_attribute("backend"):
            ctx["backend"] = archive.read_attribute_as_string("backend")
    if str(ctx["keras_version"]).startswith("1") and ctx["backend"] == "theano":
        ctx["dim_ordering"] = "th"
    return ctx


def _input_type_from_shape(shape: tuple, first_spec: KerasLayerSpec) -> InputType:
    """Map a Keras input shape (without batch dim) to an InputType."""
    shape = tuple(int(s) if s is not None else -1 for s in shape)
    if len(shape) == 3:
        h, w, c = shape
        return InputType.convolutional(h, w, c)
    if len(shape) == 2:
        t, f = shape
        return InputType.recurrent(f, None if t < 0 else t)
    if len(shape) == 1:
        layer = first_spec.layer if first_spec else None
        if layer is not None and getattr(layer, "takes_index_sequence", False):
            # Embedding over (time,) index input
            return InputType.recurrent(layer.n_in, None if shape[0] < 0 else shape[0])
        return InputType.feed_forward(shape[0])
    raise KerasImportError(f"Cannot map Keras input shape {shape} to an InputType")


def _read_layer_weights(archive: Hdf5Archive) -> Dict[str, List[np.ndarray]]:
    """Read per-layer weight lists (reference KerasModel weight copy: the
    ``model_weights`` group's layer_names/weight_names attributes; the
    Keras 3 ``.keras`` archive carries its own layers/<name>/vars layout)."""
    if hasattr(archive, "layer_weights"):
        return archive.layer_weights()
    root: Tuple[str, ...] = ()
    if archive.has_group("model_weights"):
        root = ("model_weights",)
    try:
        layer_names = archive.read_attribute_as_string_list("layer_names", *root)
    except KeyError:
        layer_names = archive.get_groups(*root)
    out: Dict[str, List[np.ndarray]] = {}
    for lname in layer_names:
        groups = root + (lname,)
        try:
            wnames = archive.read_attribute_as_string_list("weight_names", *groups)
            ws = []
            for wn in wnames:
                parts = wn.split("/")
                # weight paths are relative to the layer group; some writers
                # repeat the layer name as the first component
                for start in range(len(parts)):
                    try:
                        ws.append(archive.read_dataset(
                            "/".join(parts[start:]), *groups))
                        break
                    except KeyError:
                        continue
                else:
                    raise KerasImportError(
                        f"Cannot locate weight dataset '{wn}' for layer {lname}")
        except KeyError:
            ws = [w for _, w in archive.walk_datasets(*groups)]
        if ws:
            out[lname] = ws
    return out


def _to_output_layer(layer: DenseLayer, loss: Optional[str]) -> OutputLayer:
    """Final Dense -> OutputLayer so fit() works (reference
    KerasSequentialModel turns the training loss into a DL4J output layer)."""
    if loss is None:
        loss = {"softmax": "mcxent", "sigmoid": "xent"}.get(layer.activation, "mse")
    return OutputLayer(
        name=layer.name, n_in=layer.n_in, n_out=layer.n_out,
        has_bias=layer.has_bias, activation=layer.activation, loss=loss)


def _set_params(initialized_params: dict, initialized_state: dict,
                weight_map: dict, keras_name: str, device: torch.device):
    """Validate shapes and copy one layer's imported weights in place."""
    for key, w in weight_map.items():
        if key.startswith("__state__"):
            skey = key[len("__state__"):]
            tgt = initialized_state
            k = skey
        else:
            tgt = initialized_params
            k = key
        if k not in tgt:
            raise KerasImportError(
                f"Layer '{keras_name}': imported weight '{k}' has no "
                f"counterpart in initialized params {sorted(tgt)}")
        have = tuple(tgt[k].shape)
        want = tuple(w.shape)
        if have != want:
            raise KerasImportError(
                f"Layer '{keras_name}': weight '{k}' shape mismatch — "
                f"file has {want}, model expects {have}")
        tgt[k] = torch.as_tensor(np.asarray(w, np.float32)).to(device)


# ------------------------------------------------------------- sequential
def _convert_sequential(config: dict, ctx: dict, loss: Optional[str],
                        enforce_training_config: bool):
    layer_dicts = config["config"]
    if isinstance(layer_dicts, dict):  # Keras 2.2+/3: {'name':..., 'layers':[...]}
        layer_dicts = layer_dicts.get("layers", [])
    specs: List[Tuple[str, KerasLayerSpec]] = []
    input_shape = None
    for ld in layer_dicts:
        cname = ld["class_name"]
        cfg = ld.get("config", {})
        spec = convert_layer(cname, cfg, ctx)
        if spec.input_shape is not None and input_shape is None:
            input_shape = spec.input_shape
        if spec.is_input:
            continue
        specs.append((cfg.get("name", cname), spec))
    if input_shape is None:
        bc = config.get("config", {})
        if isinstance(bc, dict) and "build_input_shape" in bc:
            input_shape = tuple(bc["build_input_shape"][1:])
    if input_shape is None:
        raise KerasImportError("Could not determine model input shape")

    first_real = next((s for _, s in specs if s.layer is not None), None)
    input_type = _input_type_from_shape(input_shape, first_real)

    layers: List[Layer] = []
    weight_idx: List[Tuple[str, int, KerasLayerSpec]] = []  # (keras name, layer idx, spec)
    for kname, spec in specs:
        if spec.layer is None:
            continue
        idx = len(layers)
        layers.append(spec.layer)
        if spec.weights is not None:
            weight_idx.append((kname, idx, spec))
    if not layers:
        raise KerasImportError("Model has no importable layers")
    if isinstance(layers[-1], DenseLayer) and type(layers[-1]) is DenseLayer:
        layers[-1] = _to_output_layer(layers[-1], loss)
    elif enforce_training_config and not layers[-1].is_output_layer():
        raise KerasImportError(
            "enforce_training_config: final layer cannot carry a loss")
    conf = MultiLayerConfiguration(layers=tuple(layers), input_type=input_type)
    return conf, weight_idx


def import_keras_sequential_model_and_weights(
        path, model_json: Optional[str] = None,
        weights_path=None,
        enforce_training_config: bool = False, device=None) -> MultiLayerNetwork:
    """Import a Keras Sequential model (reference
    KerasModelImport.importKerasSequentialModelAndWeights :106-174) onto
    ``device``. ``path`` / ``weights_path``: a file or an opened archive."""
    if path is None and weights_path is None:
        raise KerasImportError(
            "Either a full-model .h5 path or weights_path must be provided "
            "(got path=None, weights_path=None)")
    archive, owned = _open(path)
    warchive, wowned = archive, False
    if weights_path is not None:
        warchive, wowned = _open(weights_path)
    try:
        config = _model_config(archive, model_json)
        if config.get("class_name") not in ("Sequential",):
            raise KerasImportError(
                f"Not a Sequential model: {config.get('class_name')} "
                "(use import_keras_model_and_weights)")
        ctx = _import_ctx(archive, config)
        loss = _training_loss(archive)
        conf, weight_idx = _convert_sequential(
            config, ctx, loss, enforce_training_config)
        net = MultiLayerNetwork(conf, device).init()
        lw = _read_layer_weights(warchive)
        for kname, idx, spec in weight_idx:
            if kname not in lw:
                raise KerasImportError(
                    f"No stored weights for layer '{kname}' (have {sorted(lw)})")
            wm = spec.weights(lw[kname])
            _set_params(net.params[idx], net.state[idx], wm, kname, net.device)
        return net
    finally:
        if wowned:
            warchive.close()
        if owned:
            archive.close()


# ------------------------------------------------------------- functional
def _inbound_names(ld: dict) -> List[str]:
    """Parse a functional layer's inbound connections across Keras versions:
    Keras 2 nested lists of [name, node_idx, tensor_idx, kwargs]; Keras 3
    node dicts whose args embed __keras_tensor__ keras_history entries."""
    nodes = ld.get("inbound_nodes", [])
    names: List[str] = []

    def find_history(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                names.append(obj["config"]["keras_history"][0])
            else:
                for v in obj.values():
                    find_history(v)
        elif isinstance(obj, (list, tuple)):
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int) and isinstance(obj[2], int)):
                names.append(obj[0])  # Keras 2 [name, node, tensor, ...]
            else:
                for v in obj:
                    find_history(v)

    find_history(nodes)
    return names


def _out_names(conf_entry) -> List[str]:
    """output_layers / input_layers entries across Keras versions."""
    # Keras 3 single-output: a flat [name, node_idx, tensor_idx] triple
    if (isinstance(conf_entry, (list, tuple)) and len(conf_entry) == 3
            and isinstance(conf_entry[0], str)
            and isinstance(conf_entry[1], int) and isinstance(conf_entry[2], int)):
        return [conf_entry[0]]
    names = []
    for item in conf_entry:
        if isinstance(item, (list, tuple)):
            names.append(item[0])
        elif isinstance(item, dict):  # Keras 3 keras_history form
            names.append(item["config"]["keras_history"][0])
        else:
            names.append(item)
    return names


def _convert_functional(config: dict, ctx: dict, loss: Optional[str]):
    cfg = config["config"]
    layer_dicts = cfg["layers"]
    alias: Dict[str, str] = {}       # transparent layers map to their input
    vertices: Dict[str, Tuple[object, Tuple[str, ...]]] = {}
    weight_specs: Dict[str, KerasLayerSpec] = {}
    network_inputs: List[str] = []
    input_types: List[InputType] = []

    # first pass: converted specs by name (need first consumer for input typing)
    specs: Dict[str, KerasLayerSpec] = {}
    for ld in layer_dicts:
        name = ld.get("name") or ld.get("config", {}).get("name")
        specs[name] = convert_layer(ld["class_name"], ld.get("config", {}), ctx)

    for ld in layer_dicts:
        name = ld.get("name") or ld.get("config", {}).get("name")
        spec = specs[name]
        inbound = [alias.get(n, n) for n in _inbound_names(ld)]
        if spec.is_input:
            network_inputs.append(name)
            consumers = [specs[l.get("name") or l.get("config", {}).get("name")]
                         for l in layer_dicts
                         if name in _inbound_names(l)]
            first = next((c for c in consumers if c.layer is not None), None)
            input_types.append(_input_type_from_shape(spec.input_shape, first))
            continue
        if spec.layer is None:  # transparent (Flatten): alias through
            if len(inbound) != 1:
                raise KerasImportError(
                    f"Transparent layer '{name}' must have exactly one input")
            alias[name] = inbound[0]
            continue
        vertices[name] = (spec.layer, tuple(inbound))
        if spec.weights is not None:
            weight_specs[name] = spec

    outputs = [alias.get(n, n) for n in _out_names(cfg["output_layers"])]

    # final Dense outputs become OutputLayers for trainability; any other
    # output vertex gets an identity LossLayer appended (the reference
    # likewise adds loss layers from the training config)
    from deeplearning4j_tpu_torch.nn.conf.layers import LossLayer
    for i, out in enumerate(list(outputs)):
        obj, inputs = vertices[out]
        if isinstance(obj, DenseLayer) and type(obj) is DenseLayer:
            vertices[out] = (_to_output_layer(obj, loss), inputs)
        elif not (isinstance(obj, Layer) and obj.is_output_layer()):
            loss_name = f"{out}_loss"
            vertices[loss_name] = (
                LossLayer(loss=loss or "mse", activation="identity"), (out,))
            outputs[i] = loss_name

    gconf = ComputationGraphConfiguration(
        network_inputs=tuple(network_inputs),
        vertices=vertices,
        network_outputs=tuple(outputs),
        input_types=tuple(input_types),
    )
    return gconf, weight_specs


def import_keras_model_and_weights(
        path, model_json: Optional[str] = None,
        weights_path=None, device=None) -> ComputationGraph:
    """Import a Keras functional model (reference
    KerasModelImport.importKerasModelAndWeights :50-104) onto ``device``.
    ``path`` / ``weights_path``: a file or an opened archive."""
    if path is None and weights_path is None:
        raise KerasImportError(
            "Either a full-model .h5 path or weights_path must be provided "
            "(got path=None, weights_path=None)")
    archive, owned = _open(path)
    warchive, wowned = archive, False
    if weights_path is not None:
        warchive, wowned = _open(weights_path)
    try:
        config = _model_config(archive, model_json)
        if config.get("class_name") == "Sequential":
            raise KerasImportError(
                "Sequential model: use import_keras_sequential_model_and_weights")
        ctx = _import_ctx(archive, config)
        loss = _training_loss(archive)
        gconf, weight_specs = _convert_functional(config, ctx, loss)
        net = ComputationGraph(gconf, device).init()
        lw = _read_layer_weights(warchive)
        for kname, spec in weight_specs.items():
            if kname not in lw:
                raise KerasImportError(
                    f"No stored weights for layer '{kname}' (have {sorted(lw)})")
            wm = spec.weights(lw[kname])
            _set_params(net.params[kname], net.state[kname], wm, kname, net.device)
        return net
    finally:
        if wowned:
            warchive.close()
        if owned:
            archive.close()


def import_keras_model(path, **kw):
    """Auto-detect sequential vs functional (reference KerasModelImport
    single-file entry points); ``kw`` goes on to the entry point
    (``device=`` among them)."""
    archive, owned = _open(path)
    try:
        config = _model_config(archive, None)
    finally:
        if owned:
            archive.close()
    if config.get("class_name") == "Sequential":
        return import_keras_sequential_model_and_weights(path, **kw)
    return import_keras_model_and_weights(path, **kw)
