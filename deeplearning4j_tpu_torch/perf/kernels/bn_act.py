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
take them for CPU tensors only, and for meta tensors as one kernel
operation that launches nothing (``perf/kernels/__init__.py``: the
planner's and the autotuner's measurements). On a CUDA tensor they launch
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
sums: the step averages them with the other gradients). The one launch
takes its statistics inside the launch, so on a CUDA tensor at a data
world above 1 the wrappers take the split launches instead
(:func:`bn_act_fwd_split`, :func:`bn_act_bwd_split`), each direction two
launches on the one launch's grid around one
``data_parallel.sum_over_ranks``:

- forward: a statistics launch writes this rank's sums as the one launch
  takes them (bf16/f16: float32 Σz, Σz² and the row count; float32: the
  rank's row (K, S′, Q′, n) of a zero-padded (world, 3C + 1) float64
  buffer, S′ = Σ(z − K) and Q′ = Σ(z − K)² shifted by its first row K),
  they go over the ranks in one all-reduce, and the apply launch forms the
  statistics in its prologue (float32: :func:`combine_rank_partials`'s
  re-shift to rank 0's K, in rank order, in double) and ``out``;
- backward: a sums launch writes dpre (with ``res``), this rank's
  Σdpre·x̂ and Σdpre, and the two with the row count for one all-reduce;
  the dz launch forms dz from z and dpre (with ``res``) or z and dout.

The split entries are callable at world 1 too, where they skip the
collective and reproduce the one launch bitwise in every dtype and both
directions. :func:`bn_fwd_partials_plain` and
:func:`combine_rank_partials` are the plain versions of the float32
statistics launch and of the apply launch's combination. Each split
wrapper call adds one to :data:`fwd_launches` / :data:`bwd_launches` and
to :data:`fwd_split_launches` / :data:`bwd_split_launches`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.nn import data_parallel
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.normalization import (batch_stats, normalize,
                                                            scale_shift)
from deeplearning4j_tpu_torch.perf.kernels import on_meta, take

__all__ = ["bn_act_fwd", "bn_act_bwd", "bn_act_fwd_plain", "bn_act_bwd_plain",
           "bn_act_apply_plain", "bn_fwd_partials_plain", "combine_rank_partials",
           "bn_act_fwd_split", "bn_act_bwd_split", "bn_fwd_sums", "bn_fwd_apply",
           "bn_bwd_sums", "bn_bwd_dz", "vec_width", "fwd_launches", "bwd_launches",
           "fwd_split_launches", "bwd_split_launches", "KERNEL_ACTS"]

#: wrapper calls that launched the forward kernel or its split launches (a
#: caller may reset it)
fwd_launches = 0
#: wrapper calls that launched the backward kernel or its split launches
bwd_launches = 0
#: wrapper calls that took the forward's split launches
fwd_split_launches = 0
#: wrapper calls that took the backward's split launches
bwd_split_launches = 0

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


def bn_fwd_partials_plain(z, rank: int = 0, world: int = 1):
    """The float32 statistics launch's output for this rank's ``z``: a
    zero-padded (world, 3C + 1) float64 tensor whose row ``rank`` holds
    K = z[0] (each channel's first value), S′ = Σ(z − K), Q′ = Σ(z − K)²
    and the row count, in double."""
    c = z.shape[-1]
    zd = z.reshape(-1, c).double()
    k = zd[0]
    d = zd - k
    out = torch.zeros((world, 3 * c + 1), dtype=torch.float64, device=z.device)
    out[rank, :c] = k
    out[rank, c:2 * c] = d.sum(dim=0)
    out[rank, 2 * c:3 * c] = (d * d).sum(dim=0)
    out[rank, 3 * c] = zd.shape[0]
    return out


def combine_rank_partials(parts):
    """(mean, var) in float32 from every rank's row (K, S′, Q′, n) of
    ``parts`` (world, 3C + 1), float64: each row re-shifted to rank 0's K in
    rank order, in double (δ = K_r − K_0, S += S′_r + n_r·δ, Q += Q′_r +
    2δ·S′_r + n_r·δ²), then mean = K_0 + S/n and var = max(Q/n − (S/n)², 0),
    rounded once. The apply launch's prologue, operation for operation."""
    c = (parts.shape[-1] - 1) // 3
    k0 = parts[0, :c]
    s, q, n = parts[0, c:2 * c], parts[0, 2 * c:3 * c], parts[0, 3 * c]
    for row in parts[1:]:
        d, sr, nr = row[:c] - k0, row[c:2 * c], row[3 * c]
        s = s + (sr + nr * d)
        q = q + ((row[2 * c:3 * c] + (2.0 * d) * sr) + nr * (d * d))
        n = n + nr
    dm = s / n
    return ((k0 + dm).float(),
            torch.clamp_min(q / n - dm * dm, 0.0).float())


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
_FWD_SUMS_ARGS = [_I, _I, _I, _P, _L, _I, _I, _I, _P, _P, _L, _I, _P]
_FWD_APPLY_ARGS = [_I, _I, _P, _P, _P, _P, _L, _I, _F, _I, _P, _P, _P, _P, _P, _I, _P]
_BWD_SUMS_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _L, _I, _P]
_BWD_DZ_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _I, _P]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _takes_plain(z) -> bool:
    """A CPU tensor, or a meta tensor outside a data group (the planner's
    and the autotuner's measurements): at a data world above 1 anything
    not on the CPU goes to the split launches, which run on a card only."""
    return z.device.type == "cpu" or (z.device.type == "meta" and data_parallel.world() == 1)


def _plain(family: str, fn, z, *args):
    """The plain version for a tensor on the CPU, or on the meta device as
    one kernel operation (``perf/kernels/__init__.py``)."""
    if z.device.type == "meta":
        return on_meta(family, fn, *args)
    take(family, z.device)
    return fn(*args)


def bn_act_fwd(act: str, eps: float, z, gamma, beta, res=None):
    """``(out, mean, var, inv)``; see the module docstring. Does not
    synchronise: on a card the kernel runs on the current stream."""
    global fwd_launches
    _check("bn_act_fwd", z, gamma, beta, res)
    if _takes_plain(z):
        return _plain("bn_act", bn_act_fwd_plain, z, act, eps, z, gamma, beta, res)
    if data_parallel.world() > 1:
        return bn_act_fwd_split(act, eps, z, gamma, beta, res)
    take("bn_act", z.device)
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
    if _takes_plain(z):
        return _plain("bn_act_bwd", bn_act_bwd_plain, z, act, eps, z, gamma, beta, res,
                      mean, inv, dout)
    if data_parallel.world() > 1:
        return bn_act_bwd_split(act, eps, z, gamma, beta, res, mean, inv, dout)
    take("bn_act_bwd", z.device)
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


# ----------------------------------------------------------- split launches
def _codes(z, act):
    return _DTYPES[z.dtype], KERNEL_ACTS[str(act).lower()]


def _scratch(name, z, act, has_res, vec):
    c = z.shape[-1]
    need = _kernel(name, _SCRATCH_ARGS, "sums_scratch", ctypes.c_longlong)(
        *_codes(z, act), int(has_res), z.numel() // c, c, vec)
    if need < 0:
        raise RuntimeError(f"{name} sums grid query failed with CUDA error {-need}")
    return torch.empty(need, dtype=torch.float32, device=z.device)


def bn_fwd_sums(act: str, z, has_res: bool, rank: int = 0, world: int = 1, vec=None):
    """The forward's statistics launch on CUDA ``z``: bf16/f16, float32 Σz,
    Σz² and the row count (2C + 1); float32, :func:`bn_fwd_partials_plain`'s
    zero-padded (world, 3C + 1) float64 buffer with row ``rank`` filled.
    ``act`` and ``has_res`` name the one-launch kernel whose grid it takes;
    ``vec`` defaults to what ``z`` allows."""
    c = z.shape[-1]
    n = z.numel() // c
    vec = _vec(z) if vec is None else vec
    stats = (torch.empty((world, 3 * c + 1), dtype=torch.float64, device=z.device)
             if z.dtype == torch.float32 else
             torch.empty(2 * c + 1, dtype=torch.float32, device=z.device))
    with torch.cuda.device(z.device):
        scratch = _scratch("bn_act_fwd", z, act, has_res, vec)
        err = _kernel("bn_act_fwd", _FWD_SUMS_ARGS, "sums_launch")(
            *_codes(z, act), int(has_res), z.data_ptr(), n, c, rank, world, stats.data_ptr(),
            scratch.data_ptr(), scratch.numel(), vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act_fwd sums launch failed with CUDA error {err}")
    return stats


def bn_fwd_apply(act: str, eps: float, z, gamma, beta, res, stats, vec=None):
    """The forward's apply launch on CUDA ``z``: ``(out, mean, var, inv)``
    from the statistics launch's ``stats`` summed over the ranks."""
    c = z.shape[-1]
    n = z.numel() // c
    out = torch.empty_like(z)
    vec = _vec(z, res, out) if vec is None else vec
    mean, var, inv = torch.empty((3, c), dtype=torch.float32, device=z.device)
    world = stats.shape[0] if z.dtype == torch.float32 else 1
    with torch.cuda.device(z.device):
        err = _kernel("bn_act_fwd", _FWD_APPLY_ARGS, "apply_launch")(
            *_codes(z, act), z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(res), n, c,
            float(eps), world, stats.data_ptr(), out.data_ptr(), mean.data_ptr(),
            var.data_ptr(), inv.data_ptr(), vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act_fwd apply launch failed with CUDA error {err}")
    return out, mean, var, inv


def bn_bwd_sums(act: str, z, gamma, beta, res, mean, inv, dout, vec=None):
    """The backward's sums launch on CUDA ``z``: ``(dgamma, dbeta, dpre,
    sums)``, this rank's Σdpre·x̂ and Σdpre (float32), dpre (None without
    ``res``), and the two with the row count (2C + 1 floats) for the
    all-reduce."""
    c = z.shape[-1]
    n = z.numel() // c
    dpre = None if res is None else torch.empty_like(z)
    vec = _vec(z, res, dout, dpre) if vec is None else vec
    dgamma, dbeta = torch.empty((2, c), dtype=torch.float32, device=z.device)
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        scratch = _scratch("bn_act_bwd", z, act, res is not None, vec)
        err = _kernel("bn_act_bwd", _BWD_SUMS_ARGS, "sums_launch")(
            *_codes(z, act), z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(res),
            mean.data_ptr(), inv.data_ptr(), dout.data_ptr(), n, c, dgamma.data_ptr(),
            dbeta.data_ptr(), _ptr(dpre), sums.data_ptr(), scratch.data_ptr(), scratch.numel(),
            vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act_bwd sums launch failed with CUDA error {err}")
    return dgamma, dbeta, dpre, sums


def bn_bwd_dz(act: str, z, gamma, beta, res, mean, inv, dout, dpre, sums, vec=None):
    """The backward's dz launch on CUDA ``z``: dz from the sums launch's
    ``sums`` summed over the ranks; with ``res`` it reads z and the sums
    launch's ``dpre``, without, z and ``dout``."""
    c = z.shape[-1]
    n = z.numel() // c
    dz = torch.empty_like(z)
    second = dout if res is None else dpre
    vec = _vec(z, second, dz) if vec is None else vec
    with torch.cuda.device(z.device):
        err = _kernel("bn_act_bwd", _BWD_DZ_ARGS, "dz_launch")(
            *_codes(z, act), z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(res),
            mean.data_ptr(), inv.data_ptr(), _ptr(dout), _ptr(dpre), n, c, sums.data_ptr(),
            dz.data_ptr(), vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act_bwd dz launch failed with CUDA error {err}")
    return dz


def _over_ranks(stats):
    """``stats`` summed over the data group's ranks in place (one
    collective); at world 1 as they are."""
    if data_parallel.world() > 1:
        data_parallel.sum_over_ranks(stats)
    return stats


def bn_act_fwd_split(act: str, eps: float, z, gamma, beta, res=None):
    """``(out, mean, var, inv)`` through the split launches around the data
    group's all-reduce (see the module docstring); the plain version on a
    CPU tensor."""
    global fwd_launches, fwd_split_launches
    _check("bn_act_fwd", z, gamma, beta, res)
    if z.device.type == "cpu":
        return _plain("bn_act", bn_act_fwd_plain, z, act, eps, z, gamma, beta, res)
    take("bn_act", z.device)
    _check_cuda("bn_act_fwd", act, z,
                (("z", z), ("gamma", gamma), ("beta", beta), ("res", res)), ())
    stats = bn_fwd_sums(act, z, res is not None, data_parallel.rank(), data_parallel.world(),
                        vec=_vec(z, res))
    out = bn_fwd_apply(act, eps, z, gamma, beta, res, _over_ranks(stats))
    with _count_lock:
        fwd_launches += 1
        fwd_split_launches += 1
    return out


def bn_act_bwd_split(act: str, eps: float, z, gamma, beta, res, mean, inv, dout):
    """``(dz, dgamma, dbeta, dpre)`` through the split launches around the
    data group's all-reduce (see the module docstring); dgamma and dbeta
    are this rank's sums. The plain version on a CPU tensor."""
    global bwd_launches, bwd_split_launches
    _check("bn_act_bwd", z, gamma, beta, res)
    if dout.shape != z.shape:
        raise ValueError(f"bn_act_bwd: dout {tuple(dout.shape)} does not match "
                         f"z {tuple(z.shape)}")
    if z.device.type == "cpu":
        return _plain("bn_act_bwd", bn_act_bwd_plain, z, act, eps, z, gamma, beta, res,
                      mean, inv, dout)
    take("bn_act_bwd", z.device)
    dout = dout.contiguous()
    _check_cuda("bn_act_bwd", act, z,
                (("z", z), ("gamma", gamma), ("beta", beta), ("res", res),
                 ("dout", dout)), (("mean", mean), ("inv", inv)))
    vec = _vec(z, res, dout)
    dgamma, dbeta, dpre, sums = bn_bwd_sums(act, z, gamma, beta, res, mean, inv, dout, vec)
    dz = bn_bwd_dz(act, z, gamma, beta, res, mean, inv, dout, dpre, _over_ranks(sums), vec)
    with _count_lock:
        bwd_launches += 1
        bwd_split_launches += 1
    return dz, dgamma, dbeta, dpre
