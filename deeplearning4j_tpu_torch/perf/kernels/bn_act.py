"""Train-mode batch norm + activation (+ residual add), forward and
backward: the ``bn_act_fwd`` and ``bn_act_bwd`` kernels.

Replace the TPU kernels ``deeplearning4j_tpu/perf/pallas/bn.py::bn_act_fwd``
and ``::bn_act_bwd``, the two halves of the fused conv→BN→activation
block's ``fused_bn_act_train`` (``nn/conf/convolutional.py``). For
channels-last ``z`` (rows × C, any leading shape) and per-channel
``gamma``/``beta``:

- ``bn_act_fwd(act, eps, z, gamma, beta, res) -> (out, mean, var, inv)``:
  batch stats (single-pass float32 for bf16/f16 z; for float32 z the
  centred variance, which the kernel takes from sums shifted by each
  channel's first value, in double, in the same single read),
  ``inv = rsqrt(var + eps)``, ``pre = z*scale + shift`` with
  scale/shift cast to z's dtype, ``+ res``, ``out = act(pre)``. The stats
  are in the stats dtype: float32 for bf16/f16 z, z's dtype otherwise.
- ``bn_act_bwd(act, eps, z, gamma, beta, res, mean, inv, dout) -> (dz,
  dgamma, dbeta, dpre)``: recomputes ``pre`` from z and the O(C) saves,
  ``dpre = dout * act'(pre)``, ``dgamma = Σ dpre·x̂``, ``dbeta = Σ dpre``
  (stats dtype), ``dz = scale·(dpre − dbeta/n − x̂·dgamma/n)``; ``dpre`` is
  None without ``res``.

The ``*_plain`` functions are the plain PyTorch versions: the JAX
reference's jnp math (``convolutional.py`` ``_bn_act_fwd_math`` and
``_fused_bn_act_bwd``) written in torch, for any activation. The wrappers
take them for CPU tensors only. On a CUDA tensor they launch
``csrc/bn_act_fwd.cu`` / ``csrc/bn_act_bwd.cu`` on the current stream or
raise. Each kernel is one cooperative launch that plans its own grid; the
wrapper passes what it observes, the vector width (:func:`vec_width`), and
scratch of the size the kernel asks for. The kernels take float32, bf16
and f16 with ``identity``, ``relu`` and ``leakyrelu`` (α = 0.01), the
activations ``fuse`` produces in the zoo; any other raises
``NotImplementedError``. Each wrapper call that launches adds one to
:data:`fwd_launches` / :data:`bwd_launches`.

At a data world above 1 (``nn/data_parallel.py``) the plain versions take
the batch statistics over the global batch and all-reduce Σdpre and
Σdpre·x̂ before forming dz (the returned dgamma and dbeta stay this rank's
sums: the step averages them with the other gradients). The kernels
compute the statistics inside their one launch and one card cannot hold
two ranks, so on a CUDA tensor at a data world above 1 the wrappers raise
``NotImplementedError`` (ROADMAP §A6b) and never take the plain path.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.nn import data_parallel
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.normalization import (batch_stats, normalize,
                                                            scale_shift)

__all__ = ["bn_act_fwd", "bn_act_bwd", "bn_act_fwd_plain", "bn_act_bwd_plain",
           "bn_act_apply_plain", "vec_width", "fwd_launches", "bwd_launches",
           "KERNEL_ACTS"]

#: wrapper calls that launched the forward kernel (a caller may reset it)
fwd_launches = 0
#: wrapper calls that launched the backward kernel
bwd_launches = 0

#: activation name -> the kernels' activation code
KERNEL_ACTS = {"identity": 0, "linear": 0, "relu": 1, "leakyrelu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_count_lock = threading.Lock()
_fns = {}
_fn_lock = threading.Lock()


# ------------------------------------------------------------ plain versions
def bn_act_apply_plain(act: str, z, scale, shift, res=None):
    """``act(z*scale + shift [+ res])``, scale and shift cast to z's dtype."""
    pre = normalize(z, scale, shift)
    if res is not None:
        pre = pre + res
    return get_activation(act)(pre)


def bn_act_fwd_plain(act: str, eps: float, z, gamma, beta, res=None):
    mean, var = batch_stats(z)
    scale, shift, inv = scale_shift(eps, gamma, beta, mean, var)
    return bn_act_apply_plain(act, z, scale, shift, res), mean, var, inv


def _act_vjp(act: str, pre, dout):
    """dout times the activation's derivative at ``pre``, through the same
    activation function the forward ran (the reference's ``jax.vjp``)."""
    with torch.enable_grad():
        p = pre.detach().requires_grad_(True)
        (d,) = torch.autograd.grad(get_activation(act)(p), p, dout)
    return d


def bn_act_bwd_plain(act: str, eps: float, z, gamma, beta, res, mean, inv, dout):
    sdt = mean.dtype
    scale = gamma.to(sdt) * inv
    shift = beta.to(sdt) - mean * scale
    pre = normalize(z, scale, shift)
    if res is not None:
        pre = pre + res
    dpre = _act_vjp(act, pre, dout)
    axes = tuple(range(z.dim() - 1))
    n = z.numel() // z.shape[-1]
    xhat = (z.to(sdt) - mean) * inv
    dpre32 = dpre.to(sdt)
    dgamma = (dpre32 * xhat).sum(dim=axes)
    dbeta = dpre32.sum(dim=axes)
    sum_g, sum_b = dgamma, dbeta
    if data_parallel.world() > 1:
        sum_g, sum_b, n = data_parallel.all_reduce_sums(dgamma, dbeta, rows=n)
    dz = (scale * (dpre32 - sum_b / n - xhat * (sum_g / n))).to(z.dtype)
    return dz, dgamma, dbeta, (dpre if res is not None else None)


# ------------------------------------------------------------------ wrappers
def vec_width(c: int, esize: int, aligned: bool = True) -> int:
    """The channels each thread of the kernels moves at a time over rows of
    ``c`` elements of ``esize`` bytes: 16 bytes' worth when ``c * esize`` is
    a multiple of 16 and the operands are 16-byte ``aligned``, else 1. The
    kernels plan their grids themselves."""
    return 16 // esize if aligned and (c * esize) % 16 == 0 else 1


def _vec(z, *tensors) -> int:
    """vec_width for z's rows and every (n, C) operand given (None skipped)."""
    return vec_width(z.shape[-1], z.element_size(),
                     all(t.data_ptr() % 16 == 0 for t in (z,) + tensors if t is not None))


def _check(name, z, gamma, beta, res):
    if z.dim() < 2 or z.shape[-1] == 0 or z.numel() == 0:
        raise ValueError(f"{name} takes channels-last z with at least one row "
                         f"and one channel; got shape {tuple(z.shape)}")
    c = z.shape[-1]
    for nm, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,):
            raise ValueError(f"{name}: {nm} has shape {tuple(t.shape)}, want ({c},)")
    if res is not None and (res.shape != z.shape or res.dtype != z.dtype):
        raise ValueError(f"{name}: res {tuple(res.shape)} {res.dtype} does not "
                         f"match z {tuple(z.shape)} {z.dtype}")
    for nm, t in (("gamma", gamma), ("beta", beta), ("res", res)):
        if t is not None and t.device != z.device:
            raise ValueError(f"{name}: {nm} on {t.device}, z on {z.device}")


def _check_cuda(name, act, z, tensors, stats):
    if data_parallel.world() > 1:
        raise NotImplementedError(
            f"{name} at a data-parallel world of {data_parallel.world()} ranks: the "
            "kernel takes the batch statistics inside its one launch, and the "
            "cross-rank statistics it would need wait for ROADMAP §A6b (one card "
            "holds one rank)")
    if z.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu; got {z.device}")
    if str(act).lower() not in KERNEL_ACTS:
        raise NotImplementedError(
            f"{name}: activation '{act}' has no CUDA kernel (the kernels take "
            f"{sorted(KERNEL_ACTS)})")
    if z.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or float16; "
                        f"got {z.dtype}")
    for nm, t in tensors:
        if t is None:
            continue
        if t.dtype != z.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, z is {z.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous (strides {t.stride()})")
    for nm, t in stats:
        if t.dtype != torch.float32 or t.shape != (z.shape[-1],) or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous float32 "
                             f"({z.shape[-1]},); got {t.dtype} {tuple(t.shape)}")
        if t.device != z.device:
            raise ValueError(f"{name}: {nm} on {t.device}, z on {z.device}")


def _kernel(name: str, argtypes, entry: str = "launch", restype=ctypes.c_int):
    with _fn_lock:
        if (name, entry) not in _fns:
            from deeplearning4j_tpu_torch.perf.kernels import _build
            fn = getattr(_build.load(name), f"{name}_{entry}")
            fn.argtypes = argtypes
            fn.restype = restype
            _fns[name, entry] = fn
        return _fns[name, entry]


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_ARGS = [_I, _I, _P, _P, _P, _P, _L, _I, _F, _P, _P, _P, _P, _P, _L, _I, _P]
_BWD_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _L, _I, _P]
_SCRATCH_ARGS = [_I, _I, _I, _L, _I, _I]


def _ptr(t):
    return None if t is None else t.data_ptr()


def bn_act_fwd(act: str, eps: float, z, gamma, beta, res=None):
    """``(out, mean, var, inv)``; see the module docstring. Does not
    synchronise: on a card the kernel runs on the current stream."""
    global fwd_launches
    _check("bn_act_fwd", z, gamma, beta, res)
    if z.device.type == "cpu":
        return bn_act_fwd_plain(act, eps, z, gamma, beta, res)
    _check_cuda("bn_act_fwd", act, z,
                (("z", z), ("gamma", gamma), ("beta", beta), ("res", res)), ())
    c = z.shape[-1]
    n = z.numel() // c
    out = torch.empty_like(z)
    vec = _vec(z, res, out)
    mean, var, inv = torch.empty((3, c), dtype=torch.float32, device=z.device)
    dtype, act_code = _DTYPES[z.dtype], KERNEL_ACTS[str(act).lower()]
    fn = _kernel("bn_act_fwd", _FWD_ARGS)
    with torch.cuda.device(z.device):
        need = _kernel("bn_act_fwd", _SCRATCH_ARGS, "scratch", ctypes.c_longlong)(
            dtype, act_code, int(res is not None), n, c, vec)
        if need < 0:
            raise RuntimeError(f"bn_act_fwd grid query failed with CUDA error {-need}")
        scratch = torch.empty(need, dtype=torch.float32, device=z.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dtype, act_code, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(res),
                 n, c, float(eps), out.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 inv.data_ptr(), scratch.data_ptr(), need, vec, stream)
    if err != 0:
        raise RuntimeError(f"bn_act_fwd launch failed with CUDA error {err}")
    with _count_lock:
        fwd_launches += 1
    return out, mean, var, inv


def bn_act_bwd(act: str, eps: float, z, gamma, beta, res, mean, inv, dout):
    """``(dz, dgamma, dbeta, dpre)``; see the module docstring. ``dout`` is
    made contiguous (autograd may hand it over strided)."""
    global bwd_launches
    _check("bn_act_bwd", z, gamma, beta, res)
    if dout.shape != z.shape:
        raise ValueError(f"bn_act_bwd: dout {tuple(dout.shape)} does not match "
                         f"z {tuple(z.shape)}")
    if z.device.type == "cpu":
        return bn_act_bwd_plain(act, eps, z, gamma, beta, res, mean, inv, dout)
    dout = dout.contiguous()
    _check_cuda("bn_act_bwd", act, z,
                (("z", z), ("gamma", gamma), ("beta", beta), ("res", res),
                 ("dout", dout)), (("mean", mean), ("inv", inv)))
    c = z.shape[-1]
    n = z.numel() // c
    dz = torch.empty_like(z)
    dpre = None if res is None else torch.empty_like(z)
    vec = _vec(z, res, dout, dz, dpre)
    dgamma, dbeta = (torch.empty(c, dtype=torch.float32, device=z.device)
                     for _ in range(2))
    dtype, act_code = _DTYPES[z.dtype], KERNEL_ACTS[str(act).lower()]
    fn = _kernel("bn_act_bwd", _BWD_ARGS)
    with torch.cuda.device(z.device):
        need = _kernel("bn_act_bwd", _SCRATCH_ARGS, "scratch", ctypes.c_longlong)(
            dtype, act_code, int(res is not None), n, c, vec)
        if need < 0:
            raise RuntimeError(f"bn_act_bwd grid query failed with CUDA error {-need}")
        scratch = torch.empty(need, dtype=torch.float32, device=z.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dtype, act_code, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(res),
                 mean.data_ptr(), inv.data_ptr(), dout.data_ptr(), n, c, dz.data_ptr(),
                 dgamma.data_ptr(), dbeta.data_ptr(), _ptr(dpre), scratch.data_ptr(), need,
                 vec, stream)
    if err != 0:
        raise RuntimeError(f"bn_act_bwd launch failed with CUDA error {err}")
    with _count_lock:
        bwd_launches += 1
    return dz, dgamma, dbeta, dpre
