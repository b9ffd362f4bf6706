"""The ordered embedding-table update: the ``scatter_add`` kernel.

Replaces the TPU kernel ``deeplearning4j_tpu/nlp/pallas_scatter.py::
scatter_add_pallas``:

    table[idx[n], :] += grads[n, :]   for n = 0, 1, ..., N-1, in order

table float32 ``(V, D)``, idx int32 or int64 ``(N,)``, grads float32
``(N, D)``. Duplicate indices add in n order, one rounding per add, which
is what the JAX package's ``.at[idx].add`` computes on the CPU; so the
kernel, the plain version and the JAX package agree bitwise. The update is
made **in place** on ``table`` (the JAX version donates the buffer), and
``table`` is returned. An index outside ``[0, V)`` is dropped (XLA drops an
out-of-range scatter index too; it wraps a negative one, which no caller
here passes).

- :func:`scatter_add` is the wrapper. A CPU tensor takes the plain
  version. On a CUDA tensor it orders the work with a stable sort of idx
  (plain tensor code, as the LUT is in ``adc.py``) and launches
  ``csrc/scatter_add.cu`` on the current stream, or raises, through
  :func:`launch_sorted` (the kernel alone, on sorted work), which adds one
  to :data:`launches` for each launch. The sort's outputs go to the kernel
  as they are (rows in idx's dtype, perm int64): the sort and the launch
  are the wrapper's only device work.
- :func:`scatter_add_plain` is the plain PyTorch version. It uses neither
  ``index_add_`` nor ``index_put_(accumulate=True)``, whose CUDA versions
  add with atomics in no fixed order: with the stable sort it ranks each
  position within its row, and adds rank level 0, 1, ... in turn, each
  level one vectorised step over rows that are unique within it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["scatter_add", "scatter_add_plain", "launch_sorted", "launches"]

#: kernel launches since import (or since a caller last set it to 0)
launches = 0
_count_lock = threading.Lock()
_fn = None
_fn_lock = threading.Lock()


def _check(table, idx, grads):
    if table.dtype != torch.float32 or grads.dtype != torch.float32:
        raise TypeError(f"scatter_add takes a float32 table and grads; got "
                        f"{table.dtype} and {grads.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add takes int32 or int64 indices; got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1 or grads.dim() != 2:
        raise ValueError(f"scatter_add takes a (V, D) table, (N,) idx and (N, D) "
                         f"grads; got {tuple(table.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(grads.shape)}")
    if grads.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"scatter_add: grads {tuple(grads.shape)} for "
                         f"{idx.shape[0]} indices into a table of width "
                         f"{table.shape[1]}")
    if not table.is_contiguous():
        raise ValueError("scatter_add updates the table in place: it must be "
                         "contiguous")
    if idx.device != table.device or grads.device != table.device:
        raise ValueError(f"scatter_add: operands on {table.device}, {idx.device} "
                         f"and {grads.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter_add runs on cuda or cpu; got {table.device}")


def scatter_add_plain(table: torch.Tensor, idx: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """Plain version of ``scatter_add``, in place on ``table``."""
    _check(table, idx, grads)
    n = idx.shape[0]
    if n == 0 or table.numel() == 0:
        return table
    rows, perm = torch.sort(idx, stable=True)
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = rows[1:] != rows[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    keep = (rows >= 0) & (rows < table.shape[0])
    # level k holds the k-th add of every row, ascending by row
    order = torch.sort(rank[keep], stable=True).indices
    rank, rows, src = rank[keep][order], rows[keep][order], perm[keep][order]
    g = grads.index_select(0, src)
    lo = 0
    for size in torch.bincount(rank).tolist():
        r = rows[lo:lo + size]
        table.index_put_((r,), table.index_select(0, r) + g[lo:lo + size])
        lo += size
    return table


def _kernel():
    global _fn
    with _fn_lock:
        if _fn is None:
            from deeplearning4j_tpu_torch.perf.kernels import _build
            fn = _build.load("scatter_add").scatter_add_launch
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P, P, I, P, P, ctypes.c_longlong, I, I, I, P]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def scatter_add(table: torch.Tensor, idx: torch.Tensor,
                grads: torch.Tensor) -> torch.Tensor:
    """``table[idx[n]] += grads[n]`` in n order, in place; returns ``table``.
    Does not synchronise: the kernel runs on the current stream."""
    if table.device.type == "cpu":
        return scatter_add_plain(table, idx, grads)
    _check(table, idx, grads)
    if table.shape[0] >= 2 ** 31 or idx.shape[0] >= 2 ** 31:
        raise ValueError(f"scatter_add takes fewer than 2**31 rows and indices; "
                         f"got V={table.shape[0]}, N={idx.shape[0]}")
    if idx.shape[0] == 0 or table.numel() == 0:
        return table
    # the sort orders the work (equal rows together, in n order); the adds
    # are the kernel's
    rows, perm = torch.sort(idx, stable=True)
    return launch_sorted(table, rows, perm, grads.contiguous())


def launch_sorted(table, rows, perm, grads) -> torch.Tensor:
    """The kernel alone, on work the wrapper has ordered: ``rows`` the
    stably sorted indices (int32 or int64) and ``perm`` their positions in
    ``grads`` (int64), as ``torch.sort`` returns them, on the table's card;
    ``grads`` contiguous."""
    global launches
    if rows.dtype not in (torch.int32, torch.int64) or perm.dtype != torch.int64:
        raise TypeError(f"scatter_add's kernel takes int32 or int64 rows and int64 perm; "
                        f"got {rows.dtype} and {perm.dtype}")
    v, d = table.shape
    vec = int(d % 4 == 0 and table.data_ptr() % 16 == 0 and grads.data_ptr() % 16 == 0)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.int64),
                 perm.data_ptr(), grads.data_ptr(), rows.shape[0], v, d, vec, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return table
