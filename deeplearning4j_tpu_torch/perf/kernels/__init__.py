"""Hand-written CUDA kernels, one module per kernel: wrapper, plain PyTorch
version and launch counter. Sources are in ``deeplearning4j_tpu_torch/csrc``.

This package is also the port's kernel-selection layer, the counterpart of
``deeplearning4j_tpu/perf/pallas/__init__.py``. On a CUDA tensor each
family has one implementation, its hand-written kernel; the plain PyTorch
version serves only a tensor on the CPU. So there is nothing to select:
there is no off switch on the card and no environment variable, and a
build or launch failure raises.

- ``FAMILIES``: the JAX package's five keys, each naming the boundary its
  kernel sits behind;
- ``take(family, device)``: one dispatch site's decision, True when the
  kernel serves (a CUDA tensor), counted as ``kernel.cuda_<family>`` or
  ``kernel.plain_<family>`` on the active ``CompileWatch``
  (``perf/compile_watch.bump_active``);
- ``candidate_flags()``: the autotuner's searchable arms for the kernel
  knob, ``()``: one implementation, nothing to search;
- ``selection_snapshot()``: family -> ``"cuda"`` (what a step on the card
  runs), stamped into every ``MemoryPlan``;
- ``check_kernels_flag(flag, device)``: a ``TuningRecord``'s
  ``pallas_kernels`` on a device. False on a CUDA device raises
  :class:`KernelSelectionError` (the card's off arm is ``fusion=False``,
  which takes the fused blocks and their kernels out of the network); on
  the CPU any value changes nothing.

**The meta device.** ``perf/fusion.training_activation_bytes`` and
``perf/autotune`` run a train step on ``meta`` tensors, which allocate
nothing and run nothing. A wrapper given a meta tensor calls
:func:`on_meta`: its plain version computes the output shapes (no launch
is counted), and the operation counts as one kernel operation, with its
own operand and result bytes, for whoever listens (``add_meta_observer``):
the autotuner's byte counter skips the plain body's step-by-step
operations inside it.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["FAMILIES", "KernelSelectionError", "take", "candidate_flags",
           "selection_snapshot", "check_kernels_flag", "on_meta", "inside_meta_kernel",
           "add_meta_observer", "remove_meta_observer"]

#: kernel family -> the boundary its kernel sits behind (the <family> leg
#: of the kernel.cuda_<family> / kernel.plain_<family> counters)
FAMILIES: Dict[str, str] = {
    "bn_act": "fused_bn_act_train forward (nn/conf/convolutional.py)",
    "bn_act_bwd": "fused_bn_act_train backward (autograd.Function backward)",
    "adc_pq": "PQIndex flat-ADC gather-accumulate (retrieval/pq.py)",
    "adc_ivf_pq": "IVFPQIndex per-cell-LUT gather-accumulate (retrieval/pq.py)",
    "int4_dot": "int4 nibble-unpack fused against the int32 dot (retrieval/index.py "
                "brute table, quant/lowering.py dense weights)",
}


class KernelSelectionError(ValueError):
    """A kernel selection the port cannot honour: the card has one
    implementation of each family, its hand-written kernel."""


def take(family: str, device) -> bool:
    """True when the hand-written kernel serves a call on ``device`` (a
    CUDA device); counts ``kernel.cuda_<family>`` or
    ``kernel.plain_<family>`` on the active CompileWatch."""
    from deeplearning4j_tpu_torch.perf.compile_watch import bump_active
    use = getattr(device, "type", device) == "cuda"
    bump_active(f"kernel.cuda_{family}" if use else f"kernel.plain_{family}")
    return use


def candidate_flags() -> tuple:
    """The autotuner's arms for the kernel knob: none, one implementation."""
    return ()


def selection_snapshot() -> Dict[str, str]:
    """family -> the implementation a training step on the card runs."""
    return {fam: "cuda" for fam in FAMILIES}


def check_kernels_flag(flag, device) -> None:
    """Refuse ``pallas_kernels=False`` (a TuningRecord's kernel arm) on a
    CUDA device; None, True, or any value on the CPU, pass."""
    if flag is False and getattr(device, "type", str(device).split(":")[0]) == "cuda":
        raise KernelSelectionError(
            "pallas_kernels=False asks for the reference implementation, which the "
            "card does not have: each kernel family has one implementation there, its "
            "hand-written CUDA kernel. The card's off arm is fusion=False (no fused "
            "blocks, so no bn kernels on the step)")


# ------------------------------------------------------------- meta device
_meta = threading.local()
_meta_observers: list = []


def add_meta_observer(cb) -> None:
    """``cb(family, inputs, outputs)`` after each kernel operation on meta
    tensors (lists of the tensors among its arguments and results)."""
    _meta_observers.append(cb)


def remove_meta_observer(cb) -> None:
    try:
        _meta_observers.remove(cb)
    except ValueError:
        pass


def inside_meta_kernel() -> bool:
    """Whether this thread is inside a kernel operation's plain body on
    meta tensors."""
    return getattr(_meta, "depth", 0) > 0


def _tensors(tree) -> list:
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def on_meta(family: str, plain, *args):
    """``plain(*args)`` on meta tensors as one kernel operation of
    ``family`` (module docstring)."""
    _meta.depth = getattr(_meta, "depth", 0) + 1
    try:
        out = plain(*args)
    finally:
        _meta.depth -= 1
    if _meta_observers and not inside_meta_kernel():
        ins, outs = _tensors(args), _tensors(out)
        for cb in list(_meta_observers):
            cb(family, ins, outs)
    return out
