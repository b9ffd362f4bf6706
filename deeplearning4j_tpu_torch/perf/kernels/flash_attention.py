"""Attention forward: the ``flash_attn_fwd`` kernel.

Replaces the TPU kernel that ``deeplearning4j_tpu/parallel/ring_attention.py::
flash_self_attention`` reaches, JAX's library Pallas flash attention
(``jax/experimental/pallas/ops/tpu/flash_attention.py``, forward
``pallas_call`` at :758):

    o = softmax(q k^T / sqrt(d), masked causally if asked) v

q, k, v ``(b, h, t, d)``, one dtype (float32 or bfloat16), one device, the
last axis contiguous; the b, h and t axes may have any strides, so the
head-split views of the projections go in without a copy. o has q's shape,
dtype and layout. Sums, softmax and accumulator are float32; o is rounded
once.

- :func:`flash_attention` is the wrapper. A CPU tensor takes the plain
  version. On a CUDA tensor it launches ``csrc/flash_attn_fwd.cu`` on the
  current stream, or raises, and adds one to :data:`launches`.
- The plain version is ``parallel/ring_attention.reference_attention``
  (dense scores, ``-0.7 * finfo.max`` masking, softmax over the keys). The
  kernel sums and rescales in another order, so the two agree within a
  tolerance (float32: ``1e-5 * max|v|``), not bitwise.

The kernel takes any ``t >= 1`` and head dims 1 to 256; every other input
raises here, before a launch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["flash_attention", "launches", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (or since a caller last set it to 0)
launches = 0
_count_lock = threading.Lock()
_fn = None
_fn_lock = threading.Lock()


def _check(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one (b, h, t, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1 to {MAX_HEAD_DIM}; "
                         f"got {q.shape[-1]}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if any(a.shape[-1] > 1 and a.stride(-1) != 1 for a in (q, k, v)):
        raise ValueError("flash_attention takes (b, h, t, d) tensors whose last axis is "
                         f"contiguous; got strides {q.stride()}, {k.stride()}, {v.stride()}")


def _kernel():
    global _fn
    with _fn_lock:
        if _fn is None:
            from deeplearning4j_tpu_torch.perf.kernels import _build
            fn = _build.load("flash_attn_fwd").flash_attn_fwd_launch
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Self-attention of ``(b, h, t, d)`` q, k, v; scores scaled by
    ``1/sqrt(d)``, causal if asked. Does not synchronise."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
        return reference_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu; got {q.device}")
    b, h, t, d = q.shape
    if b * h >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"flash_attention takes b*h and t below 2**31; got {tuple(q.shape)}")
    out = torch.empty_like(q)  # q's layout, when q is dense
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for a in (q, k, v, out) for s in a.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), b, h, t, d, _DTYPES[q.dtype],
                 int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
