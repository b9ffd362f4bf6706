"""int8 queries × packed int4 rows → int32: the ``int4_dot`` kernel.

Replaces the TPU kernel ``deeplearning4j_tpu/perf/pallas/adc.py::int4_matmul``
(kernel body ``_int4_dot_kernel``). It computes, in int32,

    out[i, j] = sum_{k < d} qq[i, k] * w[j, k]
    w[j, 2t] = sext(p[j, t] & 0xF),  w[j, 2t + 1] = sext(p[j, t] >> 4)

for ``qq`` int8 ``(b, d)`` and ``p`` int8 ``(n, ceil(d/2))``. For odd ``d``
the last high nibble is padding and never counts. The product is exact:
``|sum| <= d * 127 * 7``, far inside int32 for every fan-in the repo uses.

- :func:`int4_matmul` is the wrapper. A CPU tensor takes the plain version;
  a CUDA tensor launches ``csrc/int4_dot.cu`` on the current stream or
  raises. Each launch adds one to :data:`launches`.
- :func:`int4_matmul_plain` is the plain PyTorch version: unpack, then a
  float64 product (exact, every partial sum is far below 2**53) cast to
  int32. ``torch.matmul`` has no int32 kernel on CUDA.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.perf.kernels import take

from deeplearning4j_tpu_torch.quant.pack import packed_width, unpack_nibbles

__all__ = ["int4_matmul", "int4_matmul_plain", "launches"]

#: kernel launches since import (or since a caller last set it to 0)
launches = 0
_count_lock = threading.Lock()
_fn = None
_fn_lock = threading.Lock()


def int4_matmul_plain(qq: torch.Tensor, packed: torch.Tensor, d: int) -> torch.Tensor:
    """Plain version: unpack to int8 codes, float64 product, cast to int32."""
    w = unpack_nibbles(packed, d)
    return (qq.to(torch.float64) @ w.to(torch.float64).T).to(torch.int32)


def _check(qq: torch.Tensor, packed: torch.Tensor, d: int):
    if qq.dtype != torch.int8 or packed.dtype != torch.int8:
        raise TypeError(f"int4_matmul takes int8 queries and int8 packed "
                        f"rows; got {qq.dtype} and {packed.dtype}")
    if qq.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"int4_matmul takes 2-D operands; got {tuple(qq.shape)} "
                         f"and {tuple(packed.shape)}")
    if qq.shape[1] != d or packed.shape[1] != packed_width(d):
        raise ValueError(f"shapes {tuple(qq.shape)} x {tuple(packed.shape)} do "
                         f"not fit d={d}: need (b, {d}) x (n, {packed_width(d)})")
    if qq.device != packed.device:
        raise ValueError(f"operands on {qq.device} and {packed.device}")
    for name, t in (("qq", qq), ("packed", packed)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous (stride {t.stride()})")


def _kernel():
    global _fn
    with _fn_lock:
        if _fn is None:
            from deeplearning4j_tpu_torch.perf.kernels import _build
            fn = _build.load("int4_dot").int4_dot_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def int4_matmul(qq: torch.Tensor, packed: torch.Tensor, d: int) -> torch.Tensor:
    """int8 ``(b, d)`` × packed int4 ``(n, ceil(d/2))`` → int32 ``(b, n)``.
    Does not synchronise: the kernel runs on the current stream."""
    global launches
    _check(qq, packed, d)
    if qq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int4_matmul runs on cuda or cpu; got {qq.device}")
    if not take("int4_dot", qq.device):
        return int4_matmul_plain(qq, packed, d)
    b, n = qq.shape[0], packed.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=qq.device)
    if b == 0 or n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(qq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qq.data_ptr(), qq.stride(0), packed.data_ptr(),
                 packed.stride(0), out.data_ptr(), out.stride(0), b, n,
                 int(d), stream)
    if err != 0:
        raise RuntimeError(f"int4_dot launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
