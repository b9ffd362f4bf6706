"""Device-memory planner: fit a training configuration under a stated
budget (counterpart of ``deeplearning4j_tpu/perf/planner.py``).

The measure → plan → verify loop over the knobs the port has:

- **measure** — ``nn.memory.conf_memory_report`` gives the fixed bytes
  (parameters + updater state) and the per-layer activation table;
  ``perf.fusion.training_activation_bytes`` gives the saved set of a real
  train-mode forward, measured on the meta device (nothing allocated).
- **plan** — search fusion and per-layer ``remat=`` in order of increasing
  recompute cost: fuse first (same math, a smaller saved set), then remat
  the largest-activation layers in growing fractions. Each candidate's
  bytes are PREDICTED by interpolating between two measured endpoints (no
  remat, everything rematted) by the activation volume it removes.
- **verify** — the accepted candidate is measured again; a prediction that
  fit but measures over budget is rejected and the search goes on. When
  even the most aggressive plan measures over budget,
  :class:`BudgetInfeasibleError` (carrying the best plan found) is raised.

The search is the JAX package's step for step, so from the same measured
inputs both packages choose the same plan. The planned configuration is an
ordinary one: ``remat=`` runs through ``perf.fusion.remat_apply``
(``torch.utils.checkpoint``), so ``fit`` needs no change. In the spirit of
tensor-rematerialization planners (Checkmate, Jain et al. MLSys 2020;
sublinear-memory checkpointing, Chen et al. 2016), built on measured saved
sets instead of a cost-graph ILP.

Observability: ``obs`` gauges record predicted and measured activation
bytes, search seconds, candidates evaluated and the rematted layer count of
every ``plan_memory`` call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

__all__ = ["PlanError", "BudgetInfeasibleError", "MemoryPlan", "plan_memory"]


class PlanError(RuntimeError):
    """Base class for planner failures."""


class BudgetInfeasibleError(PlanError):
    """No searched plan fits the stated budget. ``best_plan`` carries the
    closest (most aggressive) plan found."""

    def __init__(self, msg: str, best_plan: Optional["MemoryPlan"] = None):
        super().__init__(msg)
        self.best_plan = best_plan


@dataclasses.dataclass
class MemoryPlan:
    """One planned configuration plus the predict/verify evidence."""

    conf: object                       # the planned configuration
    budget_bytes: int
    minibatch: int
    fixed_bytes: int                   # params + updater state
    baseline_activation_bytes: int     # unplanned measured saved set
    predicted_activation_bytes: int    # interpolated for the chosen plan
    measured_activation_bytes: Optional[int]  # verify pass (None: verify=False)
    fused: bool
    remat: Dict[str, str]              # layer key -> remat policy
    candidates_evaluated: int
    search_seconds: float
    augmentation: object = None
    # kernel selection at plan time (perf.kernels.selection_snapshot):
    # family -> implementation the step on the card runs
    kernels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def total_bytes(self) -> int:
        used = (self.measured_activation_bytes
                if self.measured_activation_bytes is not None
                else self.predicted_activation_bytes)
        return self.fixed_bytes + used

    def fits(self) -> bool:
        return self.total_bytes() <= self.budget_bytes

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("conf")
        d.pop("augmentation")
        return d

    def summary(self) -> str:
        m = self.measured_activation_bytes
        lines = [
            f"MemoryPlan: budget {self.budget_bytes / 2**20:.1f} MB @ "
            f"minibatch {self.minibatch} — {'FITS' if self.fits() else 'OVER BUDGET'}",
            f"  fixed (params+updater): {self.fixed_bytes / 2**20:.2f} MB",
            f"  activations: baseline {self.baseline_activation_bytes / 2**20:.2f} MB "
            f"-> predicted {self.predicted_activation_bytes / 2**20:.2f} MB"
            + (f", measured {m / 2**20:.2f} MB" if m is not None else ""),
            f"  fusion: {'on' if self.fused else 'off'}; remat: {len(self.remat)} layer(s)",
        ]
        for key, pol in sorted(self.remat.items()):
            lines.append(f"    {key}: remat={pol}")
        if self.kernels:
            n_cuda = sum(1 for v in self.kernels.values() if v == "cuda")
            lines.append(f"  kernels: {n_cuda}/{len(self.kernels)} families on cuda")
        lines.append(f"  search: {self.candidates_evaluated} candidate(s) in "
                     f"{self.search_seconds:.2f}s")
        return "\n".join(lines)


# ------------------------------------------------------------------ helpers
def _kernel_snapshot() -> Dict[str, str]:
    from deeplearning4j_tpu_torch.perf.kernels import selection_snapshot
    return selection_snapshot()


def _layer_entries(conf) -> List[Tuple[str, object, object]]:
    """(key, layer, index) for every layer a remat knob can land on:
    ``layer<i>`` for stacks, the vertex name for DAGs (topological order,
    the rows of ``nn.memory.conf_memory_report``)."""
    if isinstance(conf, MultiLayerConfiguration):
        return [(f"layer{i}", layer, i) for i, layer in enumerate(conf.layers)]
    out = []
    for name in conf.topological_order():
        obj = conf.vertices[name][0]
        if hasattr(obj, "init"):
            out.append((name, obj, name))
    return out


def _rematable(layer) -> bool:
    """The layer has the knob, it is unset, and it is not an output layer
    (output layers bypass ``apply_layer``)."""
    if not any(f.name == "remat" for f in dataclasses.fields(layer)):
        return False
    if layer.remat is not None:
        return False
    return not layer.is_output_layer()


def _with_remat(conf, targets: Dict[object, str]):
    """A new conf with ``remat=policy`` on the targeted layers (index ->
    policy for stacks, vertex name -> policy for DAGs)."""
    if not targets:
        return conf
    if isinstance(conf, MultiLayerConfiguration):
        layers = list(conf.layers)
        for i, pol in targets.items():
            layers[i] = dataclasses.replace(layers[i], remat=pol)
        return dataclasses.replace(conf, layers=tuple(layers))
    vertices = dict(conf.vertices)
    for name, pol in targets.items():
        obj, ins = vertices[name]
        vertices[name] = (dataclasses.replace(obj, remat=pol), ins)
    return dataclasses.replace(conf, vertices=vertices)


def _gauges():
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    reg = get_registry()
    return {
        "predicted": reg.gauge(
            "planner_predicted_activation_bytes", unit="bytes",
            help="interpolated saved-set bytes of the chosen memory plan "
                 "(perf/planner.py)"),
        "measured": reg.gauge(
            "planner_measured_activation_bytes", unit="bytes",
            help="saved-set bytes of the chosen memory plan, measured on the meta "
                 "device (training_activation_bytes verify pass)"),
        "seconds": reg.gauge(
            "planner_search_seconds", unit="seconds",
            help="wall-clock spent searching + verifying the last memory plan"),
        "candidates": reg.gauge(
            "planner_candidates_evaluated", unit="candidates",
            help="candidate plans evaluated (predicted and/or measured) by the last "
                 "plan_memory call"),
        "remat_layers": reg.gauge(
            "planner_remat_layers", unit="layers",
            help="layers the chosen memory plan recomputes in the backward "
                 "(torch.utils.checkpoint)"),
    }


# ------------------------------------------------------------------ planner
def plan_memory(conf, budget_bytes: int, minibatch: int = 32,
                fusion: object = "auto", policy: str = "nothing_saveable",
                fractions: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 1.0),
                augmentation=None, verify: bool = True) -> MemoryPlan:
    """Plan per-layer remat + fusion so training fits ``budget_bytes``.

    ``budget_bytes`` covers the training-resident set: parameters + updater
    state (fixed) plus the saved activations (what the plan moves).
    ``fusion``: ``"auto"`` (fuse when the rewriter matches anything),
    ``True`` (fuse) or ``False`` (never). ``policy`` is the
    ``REMAT_POLICIES`` name given to rematted layers; ``fractions`` is the
    escalation ladder, each step rematting that fraction of the rematable
    layers, largest activations first. ``augmentation`` runs in the
    measured step. Returns the first (cheapest-recompute) plan whose
    verified measurement fits; raises :class:`BudgetInfeasibleError` when
    none does. ``verify=False`` trusts the prediction."""
    from deeplearning4j_tpu_torch.nn.memory import conf_memory_report
    from deeplearning4j_tpu_torch.perf.fusion import (REMAT_POLICIES, fuse,
                                                      training_activation_bytes)

    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy '{policy}' "
                         f"(known: {sorted(REMAT_POLICIES)})")
    budget_bytes = int(budget_bytes)
    t0 = time.perf_counter()
    gauges = _gauges()

    rep = conf_memory_report(conf, minibatch=minibatch, training_bytes=False)
    fixed = rep.total_param_bytes + rep.updater_state_bytes
    act_budget = budget_bytes - fixed
    if act_budget <= 0:
        raise BudgetInfeasibleError(
            f"budget {budget_bytes} B cannot even hold the fixed bytes "
            f"(params + updater state = {fixed} B) at any activation plan; "
            f"shrink the model or raise the budget")

    # fusion costs no recompute and only shrinks the saved set: under
    # "auto" the planner fuses whenever the rewriter matches anything
    if fusion == "auto":
        fused_conf = fuse(conf)
        branches = [(True, fused_conf)] if fused_conf != conf else [(False, conf)]
    elif fusion:
        branches = [(True, fuse(conf))]
    else:
        branches = [(False, conf)]

    candidates = 0
    best: Optional[MemoryPlan] = None

    for fused_flag, base in branches:
        # one measured calibration point per branch: the branch baseline
        base_measured = int(training_activation_bytes(base, minibatch=minibatch,
                                                      augmentation=augmentation))
        entries = conf_memory_report(base, minibatch=minibatch, training_bytes=False).layers
        # rematable layers ranked by activation volume, biggest first
        ranked = []
        for (key, layer, idx), e in zip(_layer_entries(base), entries):
            if _rematable(layer):
                ranked.append((e.activation_bytes_per_example * minibatch, key, idx))
        ranked.sort(key=lambda t: (-t[0], str(t[2])))
        total_removable = sum(b for b, _k, _i in ranked)
        # the second calibration point: everything rematted. Predictions
        # interpolate between the two measured endpoints by removed volume
        all_measured = base_measured
        if ranked:
            all_measured = int(training_activation_bytes(
                _with_remat(base, {idx: policy for _b, _k, idx in ranked}),
                minibatch=minibatch, augmentation=augmentation))

        # adjacent fractions collapse to one layer count on small models:
        # dedupe so no plan is predicted (or measured) twice
        counts: List[int] = []
        for frac in fractions:
            n_remat = int(round(frac * len(ranked)))
            if n_remat not in counts:
                counts.append(n_remat)
        for ci, n_remat in enumerate(counts):
            chosen = ranked[:n_remat]
            removed = sum(b for b, _k, _i in chosen)
            remaining = 1.0 - removed / max(total_removable, 1)
            predicted = int(all_measured + (base_measured - all_measured) * remaining)
            candidates += 1
            plan_conf = _with_remat(base, {idx: policy for _b, _k, idx in chosen})
            plan = MemoryPlan(
                conf=plan_conf, budget_bytes=budget_bytes, minibatch=minibatch,
                fixed_bytes=int(fixed), baseline_activation_bytes=base_measured,
                predicted_activation_bytes=predicted, measured_activation_bytes=None,
                fused=fused_flag, remat={k: policy for _b, k, _i in chosen},
                candidates_evaluated=candidates, search_seconds=time.perf_counter() - t0,
                augmentation=augmentation, kernels=_kernel_snapshot())
            aggressive_last = (ci == len(counts) - 1 and (fused_flag, base) == branches[-1])
            if predicted > act_budget and not aggressive_last:
                best = _better(best, plan)
                continue
            if not verify:
                plan.search_seconds = time.perf_counter() - t0
                if predicted <= act_budget:
                    _record(gauges, plan, t0, candidates)
                    return plan
                best = _better(best, plan)
                continue
            # VERIFY: measure the planned conf's saved set
            measured = int(training_activation_bytes(plan_conf, minibatch=minibatch,
                                                     augmentation=augmentation))
            plan.measured_activation_bytes = measured
            plan.search_seconds = time.perf_counter() - t0
            if measured <= act_budget:
                _record(gauges, plan, t0, candidates)
                return plan
            best = _better(best, plan)

    _record(gauges, best, t0, candidates)
    used = None if best is None else best.total_bytes()
    raise BudgetInfeasibleError(
        f"no plan fits budget {budget_bytes} B at minibatch {minibatch}: "
        f"fixed bytes {fixed} B + best achieved activation bytes "
        f"{None if best is None else best.measured_activation_bytes or best.predicted_activation_bytes} B "
        f"= {used} B (searched {candidates} candidates, fusion branches: "
        f"{[f for f, _ in branches]}); lower the minibatch, shrink the "
        f"model, or raise the budget", best_plan=best)


def _better(best: Optional[MemoryPlan], plan: MemoryPlan) -> MemoryPlan:
    if best is None:
        return plan
    a = (plan.measured_activation_bytes if plan.measured_activation_bytes is not None
         else plan.predicted_activation_bytes)
    b = (best.measured_activation_bytes if best.measured_activation_bytes is not None
         else best.predicted_activation_bytes)
    if a != b:
        return plan if a < b else best
    # tie: a VERIFIED plan beats an equal prediction
    return (plan if plan.measured_activation_bytes is not None
            and best.measured_activation_bytes is None else best)


def _record(gauges, plan: Optional[MemoryPlan], t0: float, candidates: int):
    gauges["seconds"].set(time.perf_counter() - t0)
    gauges["candidates"].set(candidates)
    if plan is None:
        return
    gauges["predicted"].set(plan.predicted_activation_bytes)
    if plan.measured_activation_bytes is not None:
        gauges["measured"].set(plan.measured_activation_bytes)
    gauges["remat_layers"].set(len(plan.remat))
