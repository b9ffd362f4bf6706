"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C entry point.
On first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``deeplearning4j_tpu_torch/build/`` and loaded with
``ctypes``. The library's file name carries a hash of the source, of the
shared headers ``csrc/*.cuh`` and of the flags, so an edited source is never
served by a stale build. Nothing but the sources in ``csrc/`` goes into a
build. A missing ``nvcc`` or a failed build
raises; there is no fallback.

:func:`build` starts one ``nvcc`` per source, all together, and waits for
them all. ``build_log`` holds what each build's nvcc said (its
``-Xptxas -v`` report of registers, shared memory and spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_log: Dict[str, str] = {}
#: libraries this process compiled (``perf/compile_watch.backend_compile_events``)
builds = 0
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source on first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel that has no current build, with all nvcc
    processes running at once. Returns name -> library path."""
    global builds
    names = list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
        builds += 1
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]
