"""Native (C++) runtime components.

Parity surface: the reference's native layer — DataVec's record-reading hot
path (counterpart of ``deeplearning4j_tpu/native``, with its own copy of
``fastcsv.cpp``). These components cover the HOST side of the pipeline,
where C++ beats Python (byte-level parsing feeding the async iterators);
none of them is a CUDA kernel.

``fastcsv.cpp`` is compiled by ``g++`` at first use into
``deeplearning4j_tpu_torch/build/`` (gitignored), under a file name that
carries a hash of the source and flags, so an edited source is never
served by a stale build; it is loaded with ``ctypes``. On a machine
without a compiler :func:`parse_csv_numeric` returns None and the caller
parses in Python, as the JAX package does. ``parses_native`` and
``parses_python`` count which path each call took.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "build"
_FLAGS = ("-O3", "-shared", "-fPIC")
# must match fastcsv_abi_version() in fastcsv.cpp
_ABI_VERSION = 2
_lib = None
_tried = False
_lock = threading.Lock()

parses_native = 0   # parse_csv_numeric calls the native parser answered
parses_python = 0   # calls that returned None: the caller parsed in Python


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"libfastcsv-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> bool:
    """Compile ``fastcsv.cpp`` with g++ unless a current build exists.
    Returns success. The library is written under a temporary name and
    renamed into place, so concurrent builders never load half a file."""
    lib = library_path()
    if lib.exists() and not force:
        return True
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        log.info("Native build unavailable (%s); using Python fallbacks", e)
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build_native():
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
            lib.fastcsv_abi_version.restype = ctypes.c_int64
            lib.fastcsv_abi_version.argtypes = []
            got = lib.fastcsv_abi_version()
            if got != _ABI_VERSION:
                log.info("Native library ABI %d != expected %d; "
                         "using Python fallbacks", got, _ABI_VERSION)
                return None
            lib.csv_shape.restype = ctypes.c_int64
            lib.csv_shape.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
            lib.csv_parse.restype = ctypes.c_int64
            lib.csv_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64]
            _lib = lib
        except (OSError, AttributeError) as e:
            log.info("Native library load failed (%s); using Python fallbacks", e)
        return _lib


def native_available() -> bool:
    return _load() is not None


def _parse(data: bytes, delimiter: str, skip_lines: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    d = delimiter.encode()[0:1]
    rc = lib.csv_shape(data, len(data), d, skip_lines,
                       ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0 or rows.value == 0 or cols.value == 0:
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.csv_parse(data, len(data), d, skip_lines,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       rows.value, cols.value)
    return out if rc == 0 else None


def parse_csv_numeric(data: bytes, delimiter: str = ",",
                      skip_lines: int = 0) -> Optional[np.ndarray]:
    """Parse an all-numeric CSV byte buffer to a float32 (rows, cols) array
    in one native pass. Returns None when the native library is missing or
    the data has non-numeric / ragged fields (the caller falls back to the
    Python reader); counts the path taken in ``parses_native`` /
    ``parses_python``."""
    global parses_native, parses_python
    out = _parse(data, delimiter, skip_lines)
    if out is None:
        parses_python += 1
    else:
        parses_native += 1
    return out


__all__ = ["build_native", "native_available", "parse_csv_numeric", "library_path"]
