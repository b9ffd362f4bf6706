"""HDF5 archive access for Keras files (counterpart of
``deeplearning4j_tpu/modelimport/hdf5.py``).

Parity surface: reference ``keras/Hdf5Archive.java:22-25`` — there a JavaCPP
binding to native libhdf5; here ``h5py``, imported inside the functions that
read a file: file reading is host code, and a host without h5py imports the
port and passes ``import_keras_*`` any object with this module's archive
surface instead of a path (``modelimport/keras.py``).
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return [x.decode("utf-8") for x in v]
    if isinstance(v, (list, np.ndarray)):
        return [_decode(x) for x in v]
    return v


class Hdf5Archive:
    """Read-only view of a Keras HDF5 file (reference Hdf5Archive.java).

    Groups are addressed by a path of group names, mirroring the reference's
    ``readAttributeAsJson(attr, ...groups)`` / ``readDataSet(name, ...groups)``.
    """

    def __init__(self, path: str):
        import h5py
        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _group(self, groups):
        g = self._f
        for name in groups:
            g = g[name]
        return g

    def has_attribute(self, name: str, *groups: str) -> bool:
        return name in self._group(groups).attrs

    def read_attribute_as_string(self, name: str, *groups: str) -> str:
        v = self._group(groups).attrs[name]
        v = _decode(v)
        if not isinstance(v, str):
            raise TypeError(f"Attribute {name} is not a string: {type(v)}")
        return v

    def read_attribute_as_json(self, name: str, *groups: str) -> dict:
        return json.loads(self.read_attribute_as_string(name, *groups))

    def read_attribute_as_string_list(self, name: str, *groups: str) -> List[str]:
        v = _decode(self._group(groups).attrs[name])
        if isinstance(v, str):
            return [v]
        return list(v)

    def read_dataset(self, name: str, *groups: str) -> np.ndarray:
        return np.asarray(self._group(groups)[name])

    def get_data_sets(self, *groups: str) -> List[str]:
        import h5py
        g = self._group(groups)
        return [k for k, v in g.items() if isinstance(v, h5py.Dataset)]

    def get_groups(self, *groups: str) -> List[str]:
        import h5py
        g = self._group(groups)
        return [k for k, v in g.items() if isinstance(v, h5py.Group)]

    def has_group(self, name: str, *groups: str) -> bool:
        import h5py
        g = self._group(groups)
        return name in g and isinstance(g[name], h5py.Group)

    def walk_datasets(self, *groups: str):
        """Yield (path, ndarray) for every dataset below the group, in file
        order — used to read layer weights without relying on exact
        weight-name formats across Keras versions."""
        import h5py
        out = []

        def visit(path, obj):
            if isinstance(obj, h5py.Dataset):
                out.append((path, np.asarray(obj)))

        self._group(groups).visititems(visit)
        return out


class KerasV3Archive:
    """Adapter for the Keras 3 ``.keras`` zip format (config.json +
    model.weights.h5 with the ``layers/<name>/vars/<i>`` layout), exposing
    the slice of the Hdf5Archive surface the importer uses. The legacy
    ``.h5`` path stays on Hdf5Archive; ``open_model_archive`` picks."""

    def __init__(self, path: str):
        import json
        import zipfile

        self._zf = zipfile.ZipFile(path)
        try:
            self._config = json.loads(self._zf.read("config.json"))
        except KeyError:
            self._zf.close()
            from deeplearning4j_tpu_torch.modelimport.keras_layers import \
                KerasImportError
            raise KerasImportError(
                f"{path!r} is a zip but not a .keras model archive "
                "(no config.json)") from None
        self._wh5 = None  # model.weights.h5 decompresses lazily on first use

    def _weights_file(self):
        if self._wh5 is None:
            import io

            import h5py

            try:
                raw = self._zf.read("model.weights.h5")
            except KeyError:
                from deeplearning4j_tpu_torch.modelimport.keras_layers import \
                    KerasImportError
                raise KerasImportError(
                    ".keras archive has no model.weights.h5") from None
            self._wh5 = h5py.File(io.BytesIO(raw), "r")
        return self._wh5

    def close(self):
        if self._wh5 is not None:
            self._wh5.close()
            self._wh5 = None
        self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------- Hdf5Archive surface
    def has_attribute(self, name: str, *groups) -> bool:
        if name == "model_config":
            return True
        if name == "training_config":
            return bool(self._config.get("compile_config"))
        return False

    def read_attribute_as_json(self, name: str, *groups) -> dict:
        if name == "model_config":
            return self._config
        if name == "training_config":
            return self._config.get("compile_config") or {}
        raise KeyError(name)

    # ------------------------------------------------------------ weights
    @staticmethod
    def _snake(class_name: str) -> str:
        import re
        s = re.sub(r"\W+", "", class_name)
        s = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", s)
        return re.sub("([a-z])([A-Z])", r"\1_\2", s).lower()

    def _file_name_map(self) -> dict:
        """config layer name -> weights-file group name.

        The Keras 3 saver REGENERATES group names from class names
        (``dense``, ``dense_1`` ... in model order) regardless of the
        config's layer names, so name-matching the config against the file
        fails whenever the session's auto-name counters were nonzero at
        build time. Reproduce the saver's naming walk over the config."""
        cfg = self._config
        layers = (cfg.get("config") or {}).get("layers") or []
        seen: dict = {}
        out = {}
        for ld in layers:
            base = self._snake(ld.get("class_name", "layer"))
            n = seen.get(base, 0)
            seen[base] = n + 1
            out[ld["config"]["name"]] = base if n == 0 else f"{base}_{n}"
        return out

    def layer_weights(self):
        """{CONFIG layer name: [weights in variable order]} — ``vars/<i>``
        datasets sorted numerically, nested sublayers (e.g. Bidirectional)
        appended in group order."""
        import h5py
        import numpy as np

        def collect(group):
            ws = []
            vars_g = group.get("vars")
            if isinstance(vars_g, h5py.Group):
                for k in sorted(vars_g, key=int):
                    ws.append(np.asarray(vars_g[k]))
            for k in group:
                if k != "vars" and isinstance(group[k], h5py.Group):
                    ws.extend(collect(group[k]))
            return ws

        out = {}
        layers = self._weights_file().get("layers")
        if layers is None:
            return out
        name_map = self._file_name_map()
        for config_name, file_name in name_map.items():
            if file_name in layers:
                ws = collect(layers[file_name])
                if ws:
                    out[config_name] = ws
        return out


def open_model_archive(path: str):
    """Hdf5Archive for legacy .h5, KerasV3Archive for .keras zips."""
    import zipfile

    if zipfile.is_zipfile(path):
        return KerasV3Archive(path)
    return Hdf5Archive(path)
