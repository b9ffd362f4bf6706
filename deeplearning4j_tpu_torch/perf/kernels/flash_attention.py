"""Attention forward and backward: the ``flash_attn_fwd``, ``flash_attn_bwd_dkv``
and ``flash_attn_bwd_dq`` kernels.

Replaces the TPU kernels that ``deeplearning4j_tpu/parallel/ring_attention.py::
flash_self_attention`` reaches, JAX's library Pallas flash attention
(``jax/experimental/pallas/ops/tpu/flash_attention.py``): the forward
(``pallas_call`` at :758) and the two of its backward,
``_flash_attention_bwd_dkv`` (:1121) and ``_flash_attention_bwd_dq`` (:1456):

    o = softmax(s q k^T, masked causally if asked) v,   s = 1 / sqrt(d)
    L = logsumexp of the same scaled, masked scores (per row)
    D = rowsum(dO * o);   P = exp(s q k^T - L)
    dv = P^T dO;   dS = P * (dO v^T - D);   dk = s dS^T q;   dq = s dS k

q, k, v ``(b, h, t, d)``, one dtype (float32 or bfloat16), one device, the
last axis contiguous; the b, h and t axes may have any strides, so the
head-split views of the projections go in without a copy, and so does the
transposed dO that autograd hands back. Outputs keep q's (k's, v's) layout.
Sums are float32; outputs are rounded once. L and D are float32
``(b, h, t)`` contiguous.

- :func:`flash_attention` is the entry the attention layers reach. With
  grad mode on and an input that requires grad it goes through
  ``torch.autograd.Function``: the forward saves L, the backward computes D
  with a torch reduction (as the JAX library does it in plain XLA,
  ``flash_attention.py:273-275``) and runs the two backward kernels.
  Otherwise (serving, ``torch.inference_mode``) it runs the forward alone
  and computes no L.
- :func:`flash_fwd`, :func:`flash_bwd_dkv` and :func:`flash_bwd_dq` are the
  wrappers of ``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd_dkv.cu`` and
  ``csrc/flash_attn_bwd_dq.cu``. A CPU tensor takes the plain version, a
  meta tensor too, as one kernel operation that launches nothing
  (``perf/kernels/__init__.py``). On a
  CUDA tensor each launches its kernel on the current stream, or raises,
  and adds one to its counter: :data:`launches` (forward),
  :data:`launches_bwd_dkv`, :data:`launches_bwd_dq`.
- The plain versions: the forward is ``parallel/ring_attention.
  reference_attention`` (dense scores, ``-0.7 * finfo.max`` masking) plus L;
  :func:`flash_bwd_dkv_plain` and :func:`flash_bwd_dq_plain` do the dense
  math from L and D, in float32 (float64 for float64 inputs). The kernels
  mask with -inf and sum in another order, so the two agree within a
  tolerance, not bitwise.

The kernels take any ``t >= 1`` and head dims 1 to 256; every other input
raises here, before a launch.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from deeplearning4j_tpu_torch.perf.kernels import on_meta

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_fwd_plain", "flash_bwd_dkv_plain", "flash_bwd_dq_plain",
           "launches", "launches_bwd_dkv", "launches_bwd_dq", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (or since a caller last set them to 0)
launches = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0
_count_lock = threading.Lock()
_fns = {}
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


def _check_bwd(q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash attention backward: dO {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    for name, a in (("L", lse), ("D", delta)):
        if (a.shape != q.shape[:3] or a.dtype != torch.float32 or a.device != q.device
                or not a.is_contiguous()):
            raise ValueError(f"flash attention backward takes {name} as a contiguous "
                             f"float32 {tuple(q.shape[:3])} tensor on {q.device}; got "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")


def _kernel(lib: str, entry: str, n_ptrs: int):
    with _fn_lock:
        if entry not in _fns:
            from deeplearning4j_tpu_torch.perf.kernels import _build
            fn = getattr(_build.load(lib), entry)
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P] * (n_ptrs + 1) + [I] * 6 + [P]
            fn.restype = ctypes.c_int
            _fns[entry] = fn
        return _fns[entry]


def _on_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu; got {q.device}")
    b, h, t, _ = q.shape
    if b * h >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"flash attention takes b*h and t below 2**31; got {tuple(q.shape)}")


def _launch(lib, entry, tensors, strided, q, causal, name):
    """Launch ``entry`` with the pointers of ``tensors`` and the b, h, t
    strides of ``strided``; raise on an error; count the launch."""
    global launches, launches_bwd_dkv, launches_bwd_dq
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * (3 * len(strided)))(
        *(s for a in strided for s in a.stride()[:3]))
    fn = _kernel(lib, entry, len(tensors))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if a is None else a.data_ptr() for a in tensors),
                 ctypes.addressof(strides), b, h, t, d, _DTYPES[q.dtype],
                 int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    with _count_lock:
        if name == "flash_attn_fwd":
            launches += 1
        elif name == "flash_attn_bwd_dkv":
            launches_bwd_dkv += 1
        else:
            launches_bwd_dq += 1


def _fwd_kernel(q, k, v, causal, with_lse: bool):
    _on_cuda(q)
    out = torch.empty_like(q)  # q's layout, when q is dense
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        _launch("flash_attn_fwd", "flash_attn_fwd_launch", (q, k, v, out, lse),
                (q, k, v, out), q, causal, "flash_attn_fwd")
    return out, lse


# ------------------------------------------------------------- plain versions
def _scores(q, k, causal):
    """Scaled, masked scores in float32 (float64 for float64 inputs), masked
    entries at ``-0.7 * finfo.max`` as ``reference_attention`` fills them."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) / math.sqrt(q.shape[-1])
    if causal:
        t = s.shape[-1]
        keep = torch.ones((t, t), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.tensor(-0.7 * torch.finfo(ct).max, dtype=ct,
                                              device=s.device))
    return s


def flash_fwd_plain(q, k, v, causal: bool = False):
    """The forward's plain version: ``(o, L)``, ``reference_attention``'s
    output and the rows' logsumexp of the same scaled, masked scores."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
    o = reference_attention(q, k, v, causal=causal)
    return o, torch.logsumexp(_scores(q, k, causal), dim=-1)


def _dense_bwd(q, k, v, do, lse, delta, causal):
    """(P, dS, 1/s) of the dense backward, from L and D."""
    ct = torch.promote_types(q.dtype, torch.float32)
    p = torch.exp(_scores(q, k, causal) - lse[..., None].to(ct))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(ct), v.to(ct))
    return p, p * (dp - delta[..., None].to(ct)), math.sqrt(q.shape[-1])


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = False):
    """``(dk, dv)`` by dense math from L and D: dv = P^T dO, dk = s dS^T q."""
    p, ds, root = _dense_bwd(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(p.dtype))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(p.dtype)) / root
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = False):
    """``dq`` by dense math from L and D: dq = s dS k."""
    _, ds, root = _dense_bwd(q, k, v, do, lse, delta, causal)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ds.dtype)) / root).to(q.dtype)


# ------------------------------------------------------------------ wrappers
def flash_fwd(q, k, v, causal: bool = False):
    """``(o, L)``: the forward with each row's log-sum-exp. Does not
    synchronise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    if q.device.type == "meta":
        return on_meta("flash_attn_fwd", flash_fwd_plain, q, k, v, causal)
    return _fwd_kernel(q, k, v, causal, with_lse=True)


def _last_axis_contiguous(do):
    return do.contiguous() if do.shape[-1] > 1 and do.stride(-1) != 1 else do


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """``(dk, dv)`` from q, k, v, dO, L and D, in k's and v's layouts."""
    _check(q, k, v)
    _check_bwd(q, do, lse, delta)
    do = _last_axis_contiguous(do)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    if q.device.type == "meta":
        return on_meta("flash_attn_bwd_dkv", flash_bwd_dkv_plain, q, k, v, do, lse, delta,
                       causal)
    _on_cuda(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch("flash_attn_bwd_dkv", "flash_attn_bwd_dkv_launch",
                (q, k, v, do, lse, delta, dk, dv), (q, k, v, do, dk, dv), q, causal,
                "flash_attn_bwd_dkv")
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """``dq`` from q, k, v, dO, L and D, in q's layout."""
    _check(q, k, v)
    _check_bwd(q, do, lse, delta)
    do = _last_axis_contiguous(do)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    if q.device.type == "meta":
        return on_meta("flash_attn_bwd_dq", flash_bwd_dq_plain, q, k, v, do, lse, delta,
                       causal)
    _on_cuda(q)
    dq = torch.empty_like(q)
    if dq.numel():
        _launch("flash_attn_bwd_dq", "flash_attn_bwd_dq_launch",
                (q, k, v, do, lse, delta, dq), (q, k, v, do, dq), q, causal,
                "flash_attn_bwd_dq")
    return dq


class _FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward saves q, k, v, o and L; the
    backward computes D and runs the dK/dV and dQ kernels (their plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _last_axis_contiguous(do)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Self-attention of ``(b, h, t, d)`` q, k, v; scores scaled by
    ``1/sqrt(d)``, causal if asked. Differentiable when grad mode is on and
    an input requires grad; otherwise the forward alone, with no L. Does not
    synchronise."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal))
    if q.device.type == "cpu":
        from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
        return reference_attention(q, k, v, causal=causal)
    if q.device.type == "meta":
        return flash_fwd(q, k, v, causal)[0]
    return _fwd_kernel(q, k, v, causal, with_lse=False)[0]
