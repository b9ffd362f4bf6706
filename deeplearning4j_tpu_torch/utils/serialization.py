"""Model serialization: networks as one zip file, the JAX package's format
member for member (counterpart of ``deeplearning4j_tpu/utils/
serialization.py``), so a zip either package writes restores in the other.

Members:

- ``configuration.json`` — the network config (the JAX package's schema);
- ``metadata.json`` — model class, ``iteration`` / ``epoch``, format
  version, ``has_updater``; checkpoints add ``seq``, ``batch_in_epoch``,
  ``wall_time`` and ``metric``;
- ``coefficients.npz`` — parameters and layer state, keyed by the JAX
  package's ``_path_key`` of ``[params, state]``: ``0/<layer>/<name>`` in a
  ``MultiLayerNetwork`` (``0/0/W``), ``0/<vertex>/<name>`` in a graph,
  nested groups one level deeper (``0/3/q/W``), running stats under
  ``1/...``; a layer without parameters writes no key;
- ``updaterState.npz`` — updater state, keyed by the paths of optax's state
  for the same updater (:func:`updater_arrays`): layer ``k``'s slots under
  ``k/0/<slot>/...`` (``k/1/...`` for AdaDelta), where the port's slot names
  are optax's field names (``trace``, ``mu``, ``nu``, ``sum_of_squares``,
  ``e_g``, ``e_x``); Adam, AdaMax and Nadam keep ``k/0/count``, and a decay
  policy on the learning rate adds optax's schedule count ``k/1/count``.
  Where optax keeps no count (Sgd, Nesterovs, AdaGrad, RmsProp, AdaDelta,
  NoOp, no decay policy), the port's per-layer ``count`` is restored from
  the metadata's ``iteration``: every layer's count advances once a step,
  so the two agree for a network trained through ``fit``;
- ``quantization.json`` — the calibration record of a quantized network;
- ``compressState.npz`` — in a checkpoint of a network with gradient
  compression (``parallel/compress.py``): the error-feedback residual, the
  controller and the accumulators, keyed as the JAX package keys them
  (``acc/steps``, ``ctrl/tau``, ``residual/0/W``), with the scheme's
  config in the metadata's ``grad_compression``; restoring rebuilds the
  scheme and continues the residual chain bitwise.

Checkpoints (``checkpoint_zip_bytes``) are ``ZIP_STORED``; ``write_model``
is ``ZIP_DEFLATED``, as in the JAX package.

The dropout generator is the one member the packages do not share. The JAX
package stores a threefry key (``rngState.npz``, ``"has_rng": true``); a
threefry key means nothing to a ``torch.Generator`` and a Philox state
nothing to JAX. The port writes its generator's state in
``torchGeneratorState.npz`` (``"has_torch_generator": true`` and
``"torch_generator_device"``) and ``"has_rng": false``, so the JAX
package's ``restore_checkpoint`` reads a port checkpoint and keeps its own
freshly seeded key. A JAX checkpoint restored here keeps parameters,
state, updater state and counters exactly, and the dropout generator is
seeded anew from ``conf.seed + 1``.

The augmentation generator's state rides in the same member (key
``augment_state``), so a resumed run draws the crops and flips the
interrupted one would have; the metadata's ``"augmentation"`` holds an
``ImageAugmentation.to_dict()`` in both packages, and restoring a zip
re-enables it on the network.

``tuning.json`` is the autotuner's ``TuningRecord`` (``perf/autotune.py``)
of a network built by ``build_network`` (its ``_tuning_record``), JSON with
sorted keys, the JAX package's member byte for byte; the metadata says
``"has_tuning_record"`` in a checkpoint. Restoring a zip that carries it
attaches the record again, so a served or resumed network inherits the
tuned batch size and bucket ladder.
"""

from __future__ import annotations

import io
import json
import logging
import threading
import zipfile

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["write_model", "restore", "restore_multi_layer_network",
           "restore_computation_graph", "snapshot_training_state",
           "checkpoint_zip_bytes", "restore_checkpoint", "release_snapshot",
           "HostStaging", "updater_arrays", "FORMAT_VERSION"]

FORMAT_VERSION = 1
GENERATOR_MEMBER = "torchGeneratorState.npz"
_COUNTING = ("Adam", "AdaMax", "Nadam")  # optax keeps a step count at position 0


def _model_type(model) -> str:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if isinstance(model, MultiLayerNetwork):
        return "MultiLayerNetwork"
    if isinstance(model, ComputationGraph):
        return "ComputationGraph"
    raise TypeError(f"Cannot serialize {type(model)}")


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _flat(tree, prefix: str, out: dict) -> dict:
    """``{path: leaf}`` of a nested dict/list tree, paths ``/``-joined as the
    JAX package's ``_path_key`` joins them; empty containers give nothing."""
    for k, v in _items(tree):
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            _flat(v, key, out)
        else:
            out[key] = v
    return out


def _layout(updater):
    """(chain position of the slots, whether optax keeps a count at
    position 0, whether a schedule count sits at position 1)."""
    name = type(updater).__name__
    scheduled = ((getattr(updater, "lr_policy", None) or "none").lower() != "none"
                 and name not in ("AdaDelta", "NoOp"))
    return (1 if name == "AdaDelta" else 0), name in _COUNTING, scheduled


def updater_arrays(key, updater, state: dict) -> dict:
    """One layer's updater state (``{"count": int, <slot>: tree}``) under
    the optax paths ``updaterState.npz`` uses for layer ``key``. Leaves are
    passed through as they are (tensors or host arrays)."""
    pos, counting, scheduled = _layout(updater)
    out = {}
    count = np.asarray(state["count"], dtype=np.int32)
    if counting:
        out[f"{key}/0/count"] = count
    for slot in updater._slots:
        _flat(state[slot], f"{key}/{pos}/{slot}", out)
    if scheduled:
        out[f"{key}/1/count"] = count
    return out


def _updater_state(key, updater, template: dict, arrays: dict, iteration: int,
                   device) -> dict:
    """The port's state of one layer from ``updaterState.npz``'s arrays."""
    pos, counting, scheduled = _layout(updater)
    count = arrays.get(f"{key}/0/count") if counting else None
    if count is None and scheduled:
        count = arrays.get(f"{key}/1/count")
    state = {"count": int(iteration) if count is None else int(count)}
    for slot in updater._slots:
        state[slot] = _restore_tree(template[slot], arrays, f"{key}/{pos}/{slot}", device)
    return state


def _restore_tree(template, arrays: dict, prefix: str, device):
    """``template``'s structure with each leaf taken from ``arrays`` at its
    path, in the template leaf's dtype, on ``device``."""
    def one(key, leaf):
        if isinstance(leaf, (dict, list)):
            return _restore_tree(leaf, arrays, key, device)
        if key not in arrays:
            raise ValueError(f"Missing array '{key}' in checkpoint")
        saved = arrays[key]
        if tuple(saved.shape) != tuple(leaf.shape):
            raise ValueError(f"Shape mismatch for '{key}': checkpoint {saved.shape} vs "
                             f"model {tuple(leaf.shape)}")
        return torch.from_numpy(np.ascontiguousarray(saved)).to(device=device,
                                                                dtype=leaf.dtype)

    if isinstance(template, dict):
        return {k: one(f"{prefix}/{k}", v) for k, v in template.items()}
    return [one(f"{prefix}/{i}", v) for i, v in enumerate(template)]


# ------------------------------------------------------------ host copies
class HostStaging:
    """Pinned host buffers that a checkpoint manager reuses across
    snapshots: one flat buffer a dtype per snapshot, taken when the
    snapshot is copied and given back (:func:`release_snapshot`) once the
    writer has committed it, so a buffer still queued for the writer is
    never reused. Copies into pinned memory run at the link's rate, where
    pageable copies run at the host's memcpy rate."""

    def __init__(self):
        self._free: dict = {}
        self._lock = threading.Lock()

    def take(self, dtype, numel: int) -> torch.Tensor:
        with self._lock:
            free = self._free.get((dtype, numel))
            if free:
                return free.pop()
        return torch.empty(numel, dtype=dtype, pin_memory=True)

    def give_back(self, buffers):
        with self._lock:
            for b in buffers:
                self._free.setdefault((b.dtype, b.numel()), []).append(b)


def _host_arrays(tensors: dict, staging=None):
    """Finished host copies of ``{key: tensor}`` as numpy arrays, and the
    pinned buffers they live in. CUDA tensors of one dtype go into one flat
    pinned buffer from ``staging`` when given (one synchronize for all),
    else each is copied with ``.cpu()``; CPU tensors are cloned. Low
    precision leaves are widened to float32 (numpy has no bfloat16)."""
    out, buffers, groups = {}, [], {}
    for key, t in tensors.items():
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        if t.is_cuda and staging is not None:
            groups.setdefault(t.dtype, []).append((key, t))
        elif t.is_cuda:
            out[key] = t.cpu().numpy()
        else:
            out[key] = t.clone().numpy()
    if groups:
        device = next(iter(groups.values()))[0][1].device
        for dtype, items in groups.items():
            buf = staging.take(dtype, sum(t.numel() for _, t in items))
            buffers.append(buf)
            off = 0
            for key, t in items:
                view = buf[off:off + t.numel()].view(t.shape)
                view.copy_(t, non_blocking=True)
                out[key] = view.numpy()
                off += t.numel()
        # the copies are enqueued after every kernel that wrote the tensors:
        # once the stream is done, the arrays hold this step's values
        torch.cuda.current_stream(device).synchronize()
    return out, buffers


def snapshot_training_state(model, staging: HostStaging = None) -> dict:
    """A finished host copy of everything exact-step resume needs:
    parameters, layer state, updater state, the dropout generator's state
    and the step/epoch counters, as the flat arrays the zip holds. The port
    updates its masters in place, so a reference (or an unfinished
    asynchronous copy) would see later steps: every copy here is complete
    when this returns. With ``staging`` the CUDA tensors go through pinned
    buffers, which :func:`release_snapshot` gives back."""
    model_type = _model_type(model)
    if model.params is None:
        model.init()
    if model.opt_state is None:
        model._reset_updaters()
    tensors = _flat([model.params, model.state], "", {})
    upd = {}
    for k, updater in _items(model._updaters):
        upd.update(updater_arrays(k, updater, model.opt_state[k]))
    coeff_keys = list(tensors)
    tensors.update({f"u:{k}": v for k, v in upd.items() if isinstance(v, torch.Tensor)})
    comp = getattr(model, "grad_compression", None)
    cs = getattr(model, "compress_state", None)
    cs_keys = []
    if comp is not None and cs is not None:
        from deeplearning4j_tpu_torch.parallel.compress import compress_state_arrays
        cs_arrays = compress_state_arrays(cs)
        cs_keys = list(cs_arrays)
        tensors.update({f"x:{k}": v for k, v in cs_arrays.items()})
    host, buffers = _host_arrays(tensors, staging)
    coeff = {k: host[k] for k in coeff_keys}
    updater_state = {k: (host[f"u:{k}"] if isinstance(v, torch.Tensor) else v)
                     for k, v in upd.items()}
    gen = model._gen
    cal = getattr(model, "_quant_calibration", None)
    tun = getattr(model, "_tuning_record", None)
    return {
        "model_type": model_type,
        "conf_json": model.conf.to_json(),
        "iteration": int(model.iteration),
        "epoch": int(model.epoch),
        "coefficients": coeff,
        "updater_state": updater_state,
        "generator": (None if gen is None else
                      {"state": gen.get_state().numpy().copy(),
                       "augment_state": (None if model._aug_gen is None else
                                         model._aug_gen.get_state().numpy().copy()),
                       "device": gen.device.type}),
        "augmentation": _augmentation_dict(model),
        "quant_calibration": None if cal is None else cal.to_dict(),
        "tuning_record": None if tun is None else tun.to_dict(),
        "grad_compression": None if comp is None else comp.to_config(),
        "compress_state": ({k: host[f"x:{k}"] for k in cs_keys}
                           if comp is not None and cs is not None else None),
        "_buffers": buffers,
    }


def release_snapshot(snap: dict, staging: HostStaging = None):
    """Give a snapshot's pinned buffers back to ``staging``; the snapshot's
    arrays must not be read after this."""
    buffers, snap["_buffers"] = snap.get("_buffers") or [], []
    if staging is not None and buffers:
        staging.give_back(buffers)


def _write_npz(z: zipfile.ZipFile, member: str, arrays: dict):
    """The ``np.savez`` archive of ``arrays`` (a ``.npy`` entry a key)
    written straight into the member ``member`` of ``z``: each array's
    header, then its bytes from its own memory. ``np.savez`` into a buffer
    copies every byte in chunks, and the buffer is copied again into the
    outer zip; here the writer copies each byte once (the checkpoint
    writer runs beside a host-bound step loop, and copies hold the GIL)."""
    fmt = np.lib.format
    with z.open(member, "w", force_zip64=True) as out, \
            zipfile.ZipFile(out, "w", zipfile.ZIP_STORED, allowZip64=True) as npz:
        for key, arr in arrays.items():
            arr = np.asarray(arr, order="C")  # 0-d stays 0-d
            with npz.open(f"{key}.npy", "w", force_zip64=True) as f:
                fmt.write_array_header_1_0(f, fmt.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1)).cast("B"))


def checkpoint_zip_bytes(snap: dict, extra_meta: dict = None) -> memoryview:
    """A ``snapshot_training_state`` dict as checkpoint-zip bytes (built in
    memory, so the caller can hash and write them atomically; a view of the
    buffer, not a copy). ZIP_STORED: deflate shrinks float parameters by
    about a tenth at several times the CPU, on the writer thread beside the
    step loop."""
    gen = snap.get("generator")
    meta = {
        "format_version": FORMAT_VERSION,
        "model_type": snap["model_type"],
        "iteration": snap["iteration"],
        "epoch": snap["epoch"],
        "has_updater": snap["updater_state"] is not None,
        "has_rng": False,
        "has_torch_generator": gen is not None,
        "torch_generator_device": None if gen is None else gen["device"],
        "grad_compression": snap.get("grad_compression"),
        "has_compress_state": snap.get("compress_state") is not None,
        "has_quant_calibration": snap.get("quant_calibration") is not None,
        "has_tuning_record": snap.get("tuning_record") is not None,
        "augmentation": snap.get("augmentation"),
    }
    meta.update(extra_meta or {})
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr("configuration.json", snap["conf_json"])
        z.writestr("metadata.json", json.dumps(meta))
        _write_npz(z, "coefficients.npz", snap["coefficients"])
        if snap["updater_state"] is not None:
            _write_npz(z, "updaterState.npz", snap["updater_state"])
        if gen is not None:
            states = {"state": gen["state"]}
            if gen.get("augment_state") is not None:
                states["augment_state"] = gen["augment_state"]
            _write_npz(z, GENERATOR_MEMBER, states)
        if snap.get("quant_calibration") is not None:
            z.writestr("quantization.json",
                       json.dumps(snap["quant_calibration"], sort_keys=True))
        if snap.get("compress_state") is not None:
            _write_npz(z, "compressState.npz", snap["compress_state"])
        if snap.get("tuning_record") is not None:
            z.writestr("tuning.json", json.dumps(snap["tuning_record"], sort_keys=True))
    return buf.getbuffer()


def write_model(model, path, save_updater: bool = True):
    """Write ``model`` as a model zip (reference ModelSerializer.writeModel):
    configuration, metadata, coefficients and, with ``save_updater``, the
    updater state; ZIP_DEFLATED."""
    snap = snapshot_training_state(model)
    meta = {"format_version": FORMAT_VERSION, "model_type": snap["model_type"],
            "iteration": snap["iteration"], "epoch": snap["epoch"],
            "has_updater": bool(save_updater), "augmentation": _augmentation_dict(model)}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", snap["conf_json"])
        z.writestr("metadata.json", json.dumps(meta))
        _write_npz(z, "coefficients.npz", snap["coefficients"])
        if save_updater:
            _write_npz(z, "updaterState.npz", snap["updater_state"])
        if snap["quant_calibration"] is not None:
            z.writestr("quantization.json", model._quant_calibration.to_json())
        if snap["tuning_record"] is not None:
            z.writestr("tuning.json", model._tuning_record.to_json())


# ---------------------------------------------------------------- restore
def _restore_tuning_record(model, z: zipfile.ZipFile):
    """Re-attach the autotuner's TuningRecord when one rides in the zip (the
    tuned configuration itself round-trips through configuration.json)."""
    if "tuning.json" in z.namelist():
        from deeplearning4j_tpu_torch.perf.autotune import TuningRecord
        model._tuning_record = TuningRecord.from_json(z.read("tuning.json").decode())


def _augmentation_dict(model):
    aug = getattr(model, "augmentation", None)
    return None if aug is None else aug.to_dict()


def _read(source, expect, load_updater: bool, device, generator: bool):
    from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.training import _keyed
    with zipfile.ZipFile(source, "r") as z:
        meta = json.loads(z.read("metadata.json"))
        if expect is not None and meta["model_type"] != expect:
            raise ValueError(f"Checkpoint holds a {meta['model_type']}, not a {expect}")
        cfg_json = z.read("configuration.json").decode()
        if meta["model_type"] == "MultiLayerNetwork":
            model = MultiLayerNetwork(MultiLayerConfiguration.from_json(cfg_json), device)
        else:
            model = ComputationGraph(ComputationGraphConfiguration.from_json(cfg_json),
                                     device)
        model.init()  # the trees to fill, and the generator seeded anew
        coeff = dict(np.load(io.BytesIO(z.read("coefficients.npz"))))
        params = _restore_tree(model.params, coeff, "0", model.device)
        state = _restore_tree(model.state, coeff, "1", model.device)
        model.set_params(params, state)
        iteration = int(meta.get("iteration", 0))
        if (load_updater and meta.get("has_updater", True)
                and "updaterState.npz" in z.namelist()):
            arrays = dict(np.load(io.BytesIO(z.read("updaterState.npz"))))
            template = model.opt_state
            model.opt_state = _keyed(model._updaters, lambda k, u: _updater_state(
                k, u, template[k], arrays, iteration, model.device))
        if generator and meta.get("has_torch_generator") and GENERATOR_MEMBER in z.namelist():
            states = np.load(io.BytesIO(z.read(GENERATOR_MEMBER)))
            if meta.get("torch_generator_device") == model.device.type:
                model._gen.set_state(torch.from_numpy(states["state"].copy()))
                if "augment_state" in states.files:
                    model._aug_gen.set_state(torch.from_numpy(states["augment_state"].copy()))
            else:
                log.warning("the checkpoint's dropout generator is a %s generator and "
                            "this network's is a %s one; dropout is seeded anew",
                            meta.get("torch_generator_device"), model.device.type)
        if meta.get("augmentation"):
            from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
            model.set_augmentation(ImageAugmentation.from_dict(meta["augmentation"]))
        if "quantization.json" in z.namelist():
            from deeplearning4j_tpu_torch.quant.calibrate import CalibrationRecord
            model._quant_calibration = CalibrationRecord.from_json(
                z.read("quantization.json").decode())
        _restore_tuning_record(model, z)
        if meta.get("grad_compression"):
            from deeplearning4j_tpu_torch.parallel.compress import restore_compress_state
            arrays = None
            if meta.get("has_compress_state") and "compressState.npz" in z.namelist():
                arrays = dict(np.load(io.BytesIO(z.read("compressState.npz"))))
            restore_compress_state(model, meta["grad_compression"], arrays,
                                   origin="checkpointed")
        model.iteration = iteration
        model.epoch = int(meta.get("epoch", 0))
    return model, meta


def restore_checkpoint(source, load_updater: bool = True, device=None):
    """A checkpoint zip (a path or a binary file-like) as ``(model, meta)``,
    the dropout generator's state included, so a continued ``fit`` draws
    what the interrupted run would have. Zip member reads are CRC-checked,
    so a corrupted file raises instead of restoring wrong parameters."""
    return _read(source, None, load_updater, device, generator=True)


def restore(path, load_updater: bool = True, device=None):
    """A model zip of either network type, on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``)."""
    return _read(path, None, load_updater, device, generator=False)[0]


def restore_multi_layer_network(path, load_updater: bool = True, device=None):
    """reference ModelSerializer.restoreMultiLayerNetwork"""
    return _read(path, "MultiLayerNetwork", load_updater, device, generator=False)[0]


def restore_computation_graph(path, load_updater: bool = True, device=None):
    """reference ModelSerializer.restoreComputationGraph"""
    return _read(path, "ComputationGraph", load_updater, device, generator=False)[0]
