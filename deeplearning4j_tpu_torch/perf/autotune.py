"""Autotuner: search training and serving execution knobs, persist the
winner as a versioned TuningRecord (counterpart of
``deeplearning4j_tpu/perf/autotune.py``).

The knobs: batch size, the fusion rewrite, buffer donation, per-layer remat
(through the memory planner) and the serving bucket ladder.

1. **estimate** — every candidate's train step (forward, backward and the
   updaters) runs once on the meta device, which allocates nothing and
   runs nothing, and is scored ``(bytes + flops / flops_per_byte) /
   batch``, as the JAX package scores XLA's ``cost_analysis``: flops from
   ``torch.utils.flop_counter.FlopCounterMode``, bytes from a
   ``TorchDispatchMode`` that sums the operand and result bytes of every
   aten operation (views move nothing and are skipped). A hand-written
   kernel's ``autograd.Function`` counts as one operation with its own
   operand and result bytes, not as its plain body's step-by-step
   operations (``perf/kernels/__init__.py``'s meta observers).
2. **confirm** — the ``top_k`` estimated candidates are timed on the
   device on zero buffers, best of ``reps`` steps, the device synchronised
   around each step; the measured winner is recorded.
3. **persist** — a :class:`TuningRecord`: a JSON document (sorted keys,
   versioned) pinned to the architecture by a structural signature, the
   JAX package's format field for field. It rides in model zips and
   checkpoints as ``tuning.json``, so training replicas (``apply_tuning``
   / ``build_network``) and serving endpoints (``ParallelInference(
   tuning=)`` warms the recorded bucket ladder) inherit it; a record for
   another architecture is refused with :class:`StaleTuningRecordError`.

Kept differences from the JAX package: the kernel knob
(``pallas_kernels``) has no arm to search, since a card has one
implementation of each kernel family (``perf/kernels/__init__.py``); a
record's ``False`` raises ``KernelSelectionError`` on a CUDA device and
changes nothing on the CPU. ``donate`` crosses in the record, but the
port's eager step updates the masters in place either way, so the two
arms run the same step.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.perf.bucketing import BucketPolicy
from deeplearning4j_tpu_torch.perf.planner import (BudgetInfeasibleError, _with_remat,
                                                   plan_memory)

__all__ = [
    "TUNING_FORMAT_VERSION", "StaleTuningRecordError", "TuningRecord",
    "conf_signature", "verify_tuning", "apply_tuning", "build_network",
    "autotune", "step_cost",
]

TUNING_FORMAT_VERSION = 1


class StaleTuningRecordError(RuntimeError):
    """The TuningRecord was produced for a different architecture (the
    quant/ stale-record contract): applying it would mis-tune the model."""


def conf_signature(conf) -> Tuple[Tuple[str, str, int], ...]:
    """(slot key, class name, n_out) per layer/vertex in forward /
    topological order."""
    if isinstance(conf, MultiLayerConfiguration):
        return tuple((f"layer{i}", type(layer).__name__, int(getattr(layer, "n_out", 0) or 0))
                     for i, layer in enumerate(conf.layers))
    if isinstance(conf, ComputationGraphConfiguration):
        return tuple((name, type(conf.vertices[name][0]).__name__,
                      int(getattr(conf.vertices[name][0], "n_out", 0) or 0))
                     for name in conf.topological_order())
    raise TypeError(f"conf_signature expects a configuration, got {type(conf).__name__}")


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """Persisted, versioned result of one autotune search.

    ``signature`` pins the UNTUNED architecture the search ran on;
    ``tuned_signature`` the layout ``apply_tuning`` produces (``remat``
    keys address it). ``buckets`` is the serving ladder
    ``ParallelInference(tuning=)`` warms. ``objective`` holds the winner's
    estimate and measured step time, ``baseline`` the default
    configuration's estimate."""

    model_type: str
    dtype: str
    signature: Tuple[Tuple[str, str, int], ...]
    tuned_signature: Tuple[Tuple[str, str, int], ...]
    batch_size: int
    fusion: bool
    donate: bool
    remat: Dict[str, str]
    buckets: Tuple[int, ...]
    objective: Dict[str, float]
    baseline: Dict[str, float]
    candidates_searched: int
    budget_bytes: Optional[int] = None
    # the kernel-layer arm (perf/kernels): None = not searched
    pallas_kernels: Optional[bool] = None

    def to_dict(self) -> dict:
        return {
            "format_version": TUNING_FORMAT_VERSION,
            "model_type": self.model_type,
            "dtype": self.dtype,
            "signature": [list(t) for t in self.signature],
            "tuned_signature": [list(t) for t in self.tuned_signature],
            "batch_size": self.batch_size,
            "fusion": self.fusion,
            "donate": self.donate,
            "remat": dict(self.remat),
            "buckets": list(self.buckets),
            "objective": dict(self.objective),
            "baseline": dict(self.baseline),
            "candidates_searched": self.candidates_searched,
            "budget_bytes": self.budget_bytes,
            "pallas_kernels": self.pallas_kernels,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuningRecord":
        return cls(
            model_type=d["model_type"],
            dtype=d.get("dtype", "float32"),
            signature=tuple((str(t[0]), str(t[1]), int(t[2])) for t in d["signature"]),
            tuned_signature=tuple((str(t[0]), str(t[1]), int(t[2]))
                                  for t in d.get("tuned_signature", d["signature"])),
            batch_size=int(d["batch_size"]),
            fusion=bool(d["fusion"]),
            donate=bool(d.get("donate", True)),
            remat={str(k): str(v) for k, v in d.get("remat", {}).items()},
            buckets=tuple(int(b) for b in d.get("buckets", ())),
            objective={str(k): float(v) for k, v in d.get("objective", {}).items()},
            baseline={str(k): float(v) for k, v in d.get("baseline", {}).items()},
            candidates_searched=int(d.get("candidates_searched", 0)),
            budget_bytes=None if d.get("budget_bytes") is None else int(d["budget_bytes"]),
            pallas_kernels=(None if d.get("pallas_kernels") is None
                            else bool(d["pallas_kernels"])),
        )

    def to_json(self) -> str:
        # sorted keys: equal records serialize to identical bytes
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TuningRecord":
        return cls.from_dict(json.loads(s))

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TuningRecord":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())


def verify_tuning(conf, record: TuningRecord):
    """Raise :class:`StaleTuningRecordError` unless ``record`` was searched
    on this architecture: the raw layout, or the tuned layout
    ``apply_tuning`` produces."""
    sig = conf_signature(conf)
    if sig != record.signature and sig != record.tuned_signature:
        raise StaleTuningRecordError(
            f"TuningRecord does not match this architecture: record was "
            f"searched on {len(record.signature)} slots, this "
            f"{type(conf).__name__} has {len(sig)}"
            + ("" if len(sig) != len(record.signature) else
               f"; first mismatch at "
               f"{next((a for a, b in zip(sig, record.signature) if a != b), None)}")
            + " — run the autotuner for this model")


def _device_of(device) -> torch.device:
    """The device a tuned configuration runs on: ``cuda`` unless the caller
    passes ``device="cpu"`` (no card is needed to name it)."""
    return torch.device("cuda" if device is None else device)


def apply_tuning(conf, record: TuningRecord, strict: bool = True, device=None):
    """The tuned configuration: ``record.fusion`` through
    ``perf.fusion.fuse``, then the recorded per-layer remat knobs. A
    record's ``pallas_kernels=False`` raises ``KernelSelectionError`` when
    ``device`` (``cuda`` unless ``"cpu"``) is a CUDA device."""
    from deeplearning4j_tpu_torch.perf.kernels import check_kernels_flag
    check_kernels_flag(record.pallas_kernels, _device_of(device))
    sig = conf_signature(conf)
    already_tuned = sig == record.tuned_signature and sig != record.signature
    if strict and not already_tuned:
        verify_tuning(conf, record)
    out = conf
    if record.fusion and not already_tuned:
        # a conf in the tuned layout is not fused again; its remat knobs
        # still apply (the signature cannot see remat)
        from deeplearning4j_tpu_torch.perf.fusion import fuse
        out = fuse(conf)
    targets = {}
    for key, pol in record.remat.items():
        if isinstance(out, MultiLayerConfiguration):
            targets[int(key[len("layer"):])] = pol
        else:
            targets[key] = pol
    return _with_remat(out, targets)


def _net_for(conf, device):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if isinstance(conf, MultiLayerConfiguration):
        return MultiLayerNetwork(conf, device)
    return ComputationGraph(conf, device)


def build_network(conf, record: TuningRecord, device=None):
    """A network over the tuned configuration on ``device`` with the record
    attached as ``_tuning_record``: zips and checkpoints written from it
    carry ``tuning.json``."""
    net = _net_for(apply_tuning(conf, record, device=device), device)
    net._tuning_record = record
    return net


# ----------------------------------------------------------- cost machinery
class _ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Operand + result bytes of every aten operation (views skipped); a
    kernel operation on meta tensors counts once, with its own bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kernel_ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from deeplearning4j_tpu_torch.nn.tree import tree_leaves
        from deeplearning4j_tpu_torch.perf.kernels import inside_meta_kernel
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and not inside_meta_kernel():
            self.bytes += sum(_nbytes(t) for t in tree_leaves([list(args), kwargs, out]))
        return out

    def on_kernel(self, family, ins, outs):
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        self.kernel_ops[family] = self.kernel_ops.get(family, 0) + 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def step_cost(conf, minibatch: int, augmentation=None) -> dict:
    """``{"flops", "bytes_accessed", "kernel_ops"}`` of one train step of
    ``conf`` (forward, backward, updaters) run on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.perf import kernels
    from deeplearning4j_tpu_torch.perf.fusion import meta_network
    net, params, state, inputs, labels = meta_network(conf, minibatch, augmentation)
    net.params, net.state = params, state
    net._reset_updaters()
    counter = _ByteCounter()
    kernels.add_meta_observer(counter.on_kernel)
    try:
        with FlopCounterMode(display=False) as flops, counter:
            net._step(inputs, labels, None, None)
    finally:
        kernels.remove_meta_observer(counter.on_kernel)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(counter.bytes),
            "kernel_ops": dict(counter.kernel_ops)}


def _wall_clock_step(conf, minibatch: int, reps: int, device, augmentation) -> float:
    """Best-of-``reps`` seconds of one optimizer step of a fresh network on
    ``device`` over zero buffers, the device synchronised around each."""
    from deeplearning4j_tpu_torch.nn.memory import _zeros_batch
    net = _net_for(conf, device).init()
    net.set_augmentation(augmentation)
    batch = _zeros_batch(net, minibatch)
    cuda = net.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(net.device)

    net._fit_batch(batch)  # warm: kernel builds, the allocator's first growth
    sync()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        net._fit_batch(batch)
        sync()
        best = min(best, time.perf_counter() - t0)
    del net, batch
    if cuda:
        torch.cuda.empty_cache()
    return best


def _autotune_gauges():
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    reg = get_registry()
    return {
        "seconds": reg.gauge(
            "autotune_search_seconds", unit="seconds",
            help="wall-clock of the last autotune search (estimate + confirm phases)"),
        "candidates": reg.gauge(
            "autotune_candidates", unit="candidates",
            help="candidates cost-estimated by the last autotune search"),
        "step_seconds": reg.gauge(
            "autotune_best_step_seconds", unit="seconds",
            help="measured wall-clock of the winning candidate's train step "
                 "(best-of-reps, synced)"),
        "bytes": reg.gauge(
            "autotune_best_bytes_accessed", unit="bytes",
            help="meta-device bytes estimate of the winning candidate's train step"),
    }


# ----------------------------------------------------------------- autotune
def autotune(conf, batch_sizes: Sequence[int] = (8, 16, 32),
             fusion: object = "auto", donation: Sequence[bool] = (True,),
             budget_bytes: Optional[int] = None,
             top_k: int = 2, reps: int = 2, flops_per_byte: float = 8.0,
             serving_rows: Optional[Sequence[int]] = None,
             max_serving_batch: Optional[int] = None,
             augmentation=None, pallas: object = "auto", device=None) -> TuningRecord:
    """Search batch size × fusion × donation (× planner remat when
    ``budget_bytes`` is given) and return the winning :class:`TuningRecord`.

    Every candidate is estimated on the meta device (module docstring) and
    the ``top_k`` estimates are timed on ``device`` (``cuda`` unless
    ``"cpu"``); the measured winner is recorded. With ``budget_bytes`` each
    batch size is first planned by ``perf.planner.plan_memory``; batch
    sizes with no feasible plan are skipped. ``serving_rows`` (observed
    pre-pad serving row counts) learns the serving ladder through
    ``BucketPolicy.from_histogram``; otherwise the pow2 ladder up to
    ``max_serving_batch`` (default: the chosen batch size) is recorded.
    ``pallas``: ``"auto"`` or None searches no kernel arm (there is one
    implementation); True / False pins the recorded value, False raising
    ``KernelSelectionError`` on a CUDA device."""
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.perf import kernels

    t0 = time.perf_counter()
    device = resolve_device(device)
    gauges = _autotune_gauges()
    sig = conf_signature(conf)
    batch_sizes = sorted({int(b) for b in batch_sizes})
    if not batch_sizes:
        raise ValueError("autotune needs at least one batch size")
    if pallas == "auto":
        pallas_flags: Tuple = kernels.candidate_flags() or (None,)
    elif pallas is None:
        pallas_flags = (None,)
    else:
        pallas_flags = (bool(pallas),)
    for flag in pallas_flags:
        kernels.check_kernels_flag(flag, device)

    # ---- the candidate configurations per batch size
    per_batch: Dict[int, List[Tuple[dict, object]]] = {}
    for b in batch_sizes:
        variants: List[Tuple[dict, object]] = []
        if budget_bytes is not None:
            try:
                plan = plan_memory(conf, budget_bytes, minibatch=b, fusion=fusion,
                                   augmentation=augmentation)
            except BudgetInfeasibleError:
                continue  # this batch size cannot fit the budget at all
            variants.append(({"fusion": plan.fused, "remat": plan.remat}, plan.conf))
        else:
            from deeplearning4j_tpu_torch.perf.fusion import fuse
            if fusion == "auto":
                fused_conf = fuse(conf)
                variants.append(({"fusion": False, "remat": {}}, conf))
                if fused_conf != conf:
                    variants.append(({"fusion": True, "remat": {}}, fused_conf))
            elif fusion:
                variants.append(({"fusion": True, "remat": {}}, fuse(conf)))
            else:
                variants.append(({"fusion": False, "remat": {}}, conf))
        per_batch[b] = variants
    if not per_batch or not any(per_batch.values()):
        raise BudgetInfeasibleError(
            f"autotune: no batch size in {batch_sizes} has a feasible memory plan under "
            f"budget {budget_bytes} B")

    # ---- estimate: one meta-device step per (variant, batch); the kernel
    # arms and donation flags share it (neither changes the step)
    def _estimate(cost: dict, b: int) -> float:
        return (cost["bytes_accessed"] + cost["flops"] / max(flops_per_byte, 1e-9)) / b

    scored = []
    baseline_est: Optional[dict] = None
    for b, variants in per_batch.items():
        for meta, conf_c in variants:
            cost = step_cost(conf_c, b, augmentation)
            for pflag in pallas_flags:
                for donate in donation:
                    cand = {"batch_size": b, "donate": bool(donate),
                            "estimate_per_example": _estimate(cost, b), "cost": cost,
                            "conf": conf_c, "pallas": pflag, **meta}
                    scored.append(cand)
                    # the baseline the record documents its win against:
                    # smallest batch, unfused, donated, default kernels
                    if (baseline_est is None and b == batch_sizes[0]
                            and not meta["fusion"] and not meta["remat"] and not pflag):
                        baseline_est = cand
    if baseline_est is None:
        b0 = batch_sizes[0]
        cost0 = step_cost(conf, b0, augmentation)
        baseline_est = {"cost": cost0, "estimate_per_example": _estimate(cost0, b0)}
    scored.sort(key=lambda c: c["estimate_per_example"])

    # ---- confirm: time the top_k estimates on the device
    confirmed = []
    for cand in scored[:max(1, int(top_k))]:
        secs = _wall_clock_step(cand["conf"], cand["batch_size"], reps, device, augmentation)
        cand["step_seconds"] = secs
        confirmed.append((secs / cand["batch_size"], secs, cand))
    confirmed.sort(key=lambda t: t[0])
    per_ex, secs, best = confirmed[0]

    # ---- serving ladder
    if serving_rows:
        buckets = tuple(BucketPolicy.from_histogram(serving_rows)._explicit)
    else:
        top = int(max_serving_batch or best["batch_size"])
        buckets = tuple(BucketPolicy().buckets_up_to(top))

    record = TuningRecord(
        model_type=type(conf).__name__,
        dtype=conf.dtype,
        signature=sig,
        tuned_signature=conf_signature(best["conf"]),
        batch_size=best["batch_size"],
        fusion=best["fusion"],
        donate=best["donate"],
        remat=dict(best["remat"]),
        buckets=buckets,
        objective={
            "bytes_accessed": best["cost"]["bytes_accessed"],
            "flops": best["cost"]["flops"],
            "estimate_per_example": best["estimate_per_example"],
            "step_seconds": secs,
            "seconds_per_example": per_ex,
        },
        baseline={
            "bytes_accessed": baseline_est["cost"]["bytes_accessed"],
            "flops": baseline_est["cost"]["flops"],
            "estimate_per_example": baseline_est["estimate_per_example"],
        },
        candidates_searched=len(scored),
        budget_bytes=budget_bytes,
        pallas_kernels=best["pallas"],
    )
    # what each candidate scored and what the device confirmed, for a
    # caller that reports the search (not part of the record)
    autotune.last_search = [
        {"batch_size": c["batch_size"], "fusion": c["fusion"], "remat": len(c["remat"]),
         "donate": c["donate"], "estimate_per_example": c["estimate_per_example"],
         "flops": c["cost"]["flops"], "bytes_accessed": c["cost"]["bytes_accessed"],
         "step_seconds": c.get("step_seconds")} for c in scored]
    gauges["seconds"].set(time.perf_counter() - t0)
    gauges["candidates"].set(len(scored))
    gauges["step_seconds"].set(secs)
    gauges["bytes"].set(best["cost"]["bytes_accessed"])
    return record


autotune.last_search = []
