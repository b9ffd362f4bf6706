"""ADC gather-accumulate for product-quantized retrieval: the ``adc_pq`` and
``adc_ivf_pq`` kernels.

Replaces the TPU kernels of ``deeplearning4j_tpu/perf/pallas/adc.py``:
``score_pq`` (kernel body ``_adc_kernel``) and ``score_ivf_pq`` (body
``_ivf_adc_kernel``). The LUT, the probe and the CSR slot arithmetic stay
plain tensor code in ``retrieval/pq.py``, as they stay jnp in the JAX
package; only the gather-accumulate is a kernel:

    adc_pq:      d2[i, j] = sum_m lut[i, m, codes[j, m]]
    adc_ivf_pq:  d2[i, s] = sum_m lut[i, seg[i, s], m, codes[pos[i, s], m]]

Every sum starts from 0.0 and adds in m order, the JAX reference's order,
so a kernel and its plain version agree bitwise.

- :func:`adc_pq` / :func:`adc_ivf_pq` are the wrappers. A CPU tensor takes
  the plain version; a CUDA tensor launches ``csrc/adc_pq.cu`` /
  ``csrc/adc_ivf_pq.cu`` on the current stream or raises. Each launch adds
  one to :data:`pq_launches` / :data:`ivf_pq_launches`.
- :func:`adc_pq_plain` / :func:`adc_ivf_pq_plain` are the plain PyTorch
  versions: a loop over m of ``index_select`` (flat) or of
  ``take_along_dim`` on the ``(b, p*ksub)`` LUT at ``seg*ksub + code``
  (IVF), accumulated in order.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.perf.kernels import take

__all__ = ["adc_pq", "adc_pq_plain", "adc_ivf_pq", "adc_ivf_pq_plain",
           "pq_launches", "ivf_pq_launches"]

#: kernel launches since import (or since a caller last set them to 0)
pq_launches = 0
ivf_pq_launches = 0
_count_lock = threading.Lock()
_fns = {}
_fn_lock = threading.Lock()

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "adc_pq": [_P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "adc_ivf_pq": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _I, _P],
}


def adc_pq_plain(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of ``adc_pq``: ``(b, M, ksub)`` x ``(n, M)`` -> ``(b, n)``."""
    b, m_count, _ = lut.shape
    d2 = torch.zeros((b, codes.shape[0]), dtype=torch.float32, device=lut.device)
    for m in range(m_count):
        d2 = d2 + lut[:, m, :].index_select(1, codes[:, m].long())
    return d2


def adc_ivf_pq_plain(lut: torch.Tensor, flat_codes: torch.Tensor,
                     seg: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain version of ``adc_ivf_pq``: ``(b, p, M, ksub)`` LUTs, ``(n, M)``
    codes, ``(b, C)`` seg/pos -> ``(b, C)``."""
    b, p, m_count, ksub = lut.shape
    seg64 = seg.long() * ksub
    rows = flat_codes[pos.long()]                          # (b, C, M)
    d2 = torch.zeros(seg.shape, dtype=torch.float32, device=lut.device)
    for m in range(m_count):
        lut_m = lut[:, :, m, :].reshape(b, p * ksub)
        d2 = d2 + torch.take_along_dim(lut_m, seg64 + rows[..., m].long(), dim=1)
    return d2


def _kernel(name: str):
    with _fn_lock:
        if name not in _fns:
            from deeplearning4j_tpu_torch.perf.kernels import _build
            fn = getattr(_build.load(name), f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def _check_common(lut, codes, lut_dim, name):
    if lut.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"{name} takes a float32 LUT and uint8 codes; got "
                        f"{lut.dtype} and {codes.dtype}")
    if lut.dim() != lut_dim or codes.dim() != 2:
        raise ValueError(f"{name} takes a {lut_dim}-D LUT and 2-D codes; got "
                         f"{tuple(lut.shape)} and {tuple(codes.shape)}")
    if codes.shape[1] != lut.shape[-2]:
        raise ValueError(f"{name}: codes have {codes.shape[1]} subspaces, the "
                         f"LUT {lut.shape[-2]}")
    if not 1 <= lut.shape[-1] <= 256:
        raise ValueError(f"{name}: ksub must be in [1, 256] (codes are one "
                         f"byte); got {lut.shape[-1]}")
    if codes.device != lut.device:
        raise ValueError(f"{name}: operands on {lut.device} and {codes.device}")
    if lut.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu; got {lut.device}")


def _vec8(codes: torch.Tensor) -> int:
    return int(codes.shape[1] == 8 and codes.data_ptr() % 8 == 0)


def adc_pq(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Flat ADC: float32 LUT ``(b, M, ksub)`` and uint8 codes ``(n, M)`` ->
    float32 ``(b, n)``. Does not synchronise: the kernel runs on the
    current stream."""
    global pq_launches
    _check_common(lut, codes, 3, "adc_pq")
    if not take("adc_pq", lut.device):
        return adc_pq_plain(lut, codes)
    lut, codes = lut.contiguous(), codes.contiguous()
    b, m_count, ksub = lut.shape
    n = codes.shape[0]
    d2 = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    if b == 0 or n == 0:
        return d2
    fn = _kernel("adc_pq")
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lut.data_ptr(), codes.data_ptr(), d2.data_ptr(), b, n,
                 m_count, ksub, _vec8(codes), stream)
    if err != 0:
        raise RuntimeError(f"adc_pq launch failed with CUDA error {err}")
    with _count_lock:
        pq_launches += 1
    return d2


def adc_ivf_pq(lut: torch.Tensor, flat_codes: torch.Tensor,
               seg: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """IVF-PQ ADC over CSR slots: float32 LUTs ``(b, p, M, ksub)``, uint8
    codes ``(n, M)``, int32 ``seg`` / ``pos`` ``(b, C)`` -> float32
    ``(b, C)``. Does not synchronise."""
    global ivf_pq_launches
    _check_common(lut, flat_codes, 4, "adc_ivf_pq")
    if seg.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"adc_ivf_pq takes int32 seg and pos; got {seg.dtype} "
                        f"and {pos.dtype}")
    b, p, m_count, ksub = lut.shape
    if seg.dim() != 2 or seg.shape != pos.shape or seg.shape[0] != b:
        raise ValueError(f"adc_ivf_pq: seg {tuple(seg.shape)} and pos "
                         f"{tuple(pos.shape)} must both be (b={b}, C)")
    if seg.device != lut.device or pos.device != lut.device:
        raise ValueError("adc_ivf_pq: operands on different devices")
    if not take("adc_ivf_pq", lut.device):
        return adc_ivf_pq_plain(lut, flat_codes, seg, pos)
    if b > 65535:
        raise ValueError(f"adc_ivf_pq takes at most 65535 queries a launch; got {b}")
    lut, flat_codes = lut.contiguous(), flat_codes.contiguous()
    seg, pos = seg.contiguous(), pos.contiguous()
    c = seg.shape[1]
    d2 = torch.empty((b, c), dtype=torch.float32, device=lut.device)
    if b == 0 or c == 0:
        return d2
    if flat_codes.shape[0] == 0:
        raise ValueError("adc_ivf_pq: empty code table")
    fn = _kernel("adc_ivf_pq")
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lut.data_ptr(), flat_codes.data_ptr(), seg.data_ptr(),
                 pos.data_ptr(), d2.data_ptr(), b, c, p, m_count, ksub,
                 flat_codes.shape[0], _vec8(flat_codes), stream)
    if err != 0:
        raise RuntimeError(f"adc_ivf_pq launch failed with CUDA error {err}")
    with _count_lock:
        ivf_pq_launches += 1
    return d2
