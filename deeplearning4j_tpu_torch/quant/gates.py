"""Accuracy gates: does the int8 serving graph still answer like fp32?
(Counterpart of ``deeplearning4j_tpu/quant/gates.py``: the same report for
the same outputs; each batch's outputs are read to the host.)

``accuracy_delta(fp32_net, q_net, iterator)`` drives one labeled batch
stream through BOTH networks (the eval/ subsystem accumulates the
classification metrics) and reports:

- per-network top-1 accuracy and their absolute delta,
- top-1 AGREEMENT (fraction of examples where the two nets pick the same
  class — the stricter signal on weakly-trained models whose accuracies
  can agree by luck),
- per-network mean NLL over the EVAL-mode output probabilities and the
  relative delta. The loss is computed from ``output()`` (what serving
  returns), not ``score_dataset()``: a BN-bearing fp32 graph's score runs
  the train-mode forward (batch statistics), which is not the function the
  quantized serving graph replaces.

``assert_accuracy_within(report)`` is the gate: the tier-1 quantization
tests assert every zoo CNN and keras import passes the stated budget
(default ≤1 percentage point top-1 delta, ≤1% relative loss delta).
The measured delta lands in the obs registry as ``quant_accuracy_delta``
so a serving fleet's rollout automation can scrape the same number the
tests gate on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation, as_host

__all__ = ["accuracy_delta", "assert_accuracy_within"]


def _net_output(net, ds: DataSet) -> np.ndarray:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    if isinstance(net, ComputationGraph):
        fm = None if ds.features_mask is None else [ds.features_mask]
        return as_host(net.output_single(ds.features, features_masks=fm))
    return as_host(net.output(ds.features, features_mask=ds.features_mask))


def _nll(labels: np.ndarray, probs: np.ndarray, mask) -> np.ndarray:
    """Per-example negative log-likelihood from output probabilities
    (clipped so a saturated 0 never turns into inf)."""
    y = as_host(labels)
    y = y.reshape(-1, y.shape[-1])
    p = as_host(probs).reshape(y.shape)
    nll = -np.log(np.clip((y * p).sum(axis=-1), 1e-12, None))
    if mask is not None:
        nll = nll[as_host(mask).reshape(-1).astype(bool)]
    return nll


def accuracy_delta(fp32_net, q_net, iterator, top_n: int = 1) -> dict:
    """Compare a quantized net against its fp32 source over one labeled
    stream (DataSets with one-hot labels, as ``evaluate()`` takes). Both
    nets see the SAME batches. Returns the report dict described in the
    module docstring; publishes ``quant_accuracy_delta``."""
    e_f, e_q = Evaluation(top_n=top_n), Evaluation(top_n=top_n)
    agree = total = 0
    nll_f: list = []
    nll_q: list = []
    batches = 0
    for ds in iterator:
        if not isinstance(ds, DataSet):
            ds = DataSet(np.asarray(ds[0]), np.asarray(ds[1]))
        out_f = _net_output(fp32_net, ds)
        out_q = _net_output(q_net, ds)
        e_f.eval(ds.labels, out_f, mask=ds.labels_mask)
        e_q.eval(ds.labels, out_q, mask=ds.labels_mask)
        pf = np.argmax(out_f.reshape(-1, out_f.shape[-1]), axis=-1)
        pq = np.argmax(out_q.reshape(-1, out_q.shape[-1]), axis=-1)
        if ds.labels_mask is not None:
            m = as_host(ds.labels_mask).reshape(-1).astype(bool)
            pf, pq = pf[m], pq[m]
        agree += int((pf == pq).sum())
        total += len(pf)
        nll_f.append(_nll(ds.labels, out_f, ds.labels_mask))
        nll_q.append(_nll(ds.labels, out_q, ds.labels_mask))
        batches += 1
    if batches == 0:
        raise ValueError("accuracy_delta(): empty evaluation stream")
    loss_f = float(np.mean(np.concatenate(nll_f)))
    loss_q = float(np.mean(np.concatenate(nll_q)))
    top1_delta = abs(e_f.accuracy() - e_q.accuracy())
    report = {
        "examples": total,
        "fp32_top1": e_f.accuracy(),
        "quant_top1": e_q.accuracy(),
        "top1_delta": top1_delta,
        "top1_agreement": agree / total if total else 0.0,
        "fp32_loss": loss_f,
        "quant_loss": loss_q,
        "loss_delta_rel": abs(loss_q - loss_f) / max(abs(loss_f), 1e-12),
    }
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    get_registry().gauge(
        "quant_accuracy_delta", unit="fraction",
        help="absolute top-1 accuracy delta of the most recent int8-vs-"
             "fp32 accuracy gate run (accuracy_delta harness)",
    ).set(top1_delta)
    return report


def assert_accuracy_within(report: dict, top1_budget: float = 0.01,
                           loss_budget: float = 0.01,
                           agreement_floor: Optional[float] = None):
    """The quantization accuracy gate: raise with the full report when the
    measured deltas exceed the budget (defaults: ≤1pp top-1 delta, ≤1%
    relative loss delta; pass ``agreement_floor`` to additionally require a
    minimum top-1 agreement)."""
    fails = []
    if report["top1_delta"] > top1_budget:
        fails.append(f"top-1 delta {report['top1_delta']:.4f} > "
                     f"budget {top1_budget}")
    if report["loss_delta_rel"] > loss_budget:
        fails.append(f"relative loss delta {report['loss_delta_rel']:.4f} "
                     f"> budget {loss_budget}")
    if agreement_floor is not None and \
            report["top1_agreement"] < agreement_floor:
        fails.append(f"top-1 agreement {report['top1_agreement']:.4f} < "
                     f"floor {agreement_floor}")
    if fails:
        raise AssertionError(
            "quantized model failed the accuracy gate: "
            + "; ".join(fails) + f" (report: {report})")
    return report
