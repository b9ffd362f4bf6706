#!/usr/bin/env python3
"""Where TinyYOLO's detection configuration, as the zoo publishes it, turns
non-finite on one card.

    python3 tools/yolo_divergence.py

Trains chip_smoke.py's yolo_training network without the gradient
renormalization that phase adds (416 x 416 x 3, 20 classes, the five VOC
priors, fused, the model's Nesterovs(1e-3, 0.9), batch 64 of one fixed
synthetic batch, 20 steps through MultiLayerNetwork.fit) in four runs on
the batch of seed 0: bf16 and float32 compute, each with the fused blocks'
BN tail through the bn_act kernels and through their plain PyTorch
versions; then the kernels in bf16 and float32 on the batches of seeds 1
and 2. For every run it records, a step at a time:

- the loss, and the first step whose loss is not finite;
- for each of the 7 fused blocks, the smallest batch variance over the
  channels as the BN tail returned it, the same from a float64 two-pass
  over z, the largest relative error between the two and the largest
  mean^2 / variance (a single-pass variance cancels as that grows);
- the range of the YOLO head's width/height logits, and the entries of the
  loss gradient at the head's input that are not finite, by slot of the
  25 per box (0-1 xy, 2-3 wh, 4 confidence, 5-24 classes);
- the layers whose float32 master parameters are not finite after the step.

Prints the card line and one JSON line per run. Needs a card; builds the
two bn kernels from the checkout.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STEPS = 20
RUNS = [(0, "bfloat16", "kernel"), (0, "bfloat16", "plain"), (0, "float32", "kernel"),
        (0, "float32", "plain"), (1, "bfloat16", "kernel"), (1, "float32", "kernel"),
        (2, "bfloat16", "kernel"), (2, "float32", "kernel")]


def _finite(v):
    return v if np.isfinite(v) else None


def main() -> int:
    if not torch.cuda.is_available():
        print("yolo_divergence: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.perf.kernels import _build, bn_act

    print(f"card: {cs.card_line()}", flush=True)
    _build.build(["bn_act_fwd", "bn_act_bwd"])
    dev = resolve_device("cuda")
    kernels = {"kernel": (bn_act.bn_act_fwd, bn_act.bn_act_bwd),
               "plain": (bn_act.bn_act_fwd_plain, bn_act.bn_act_bwd_plain)}
    score = Yolo2OutputLayer.compute_score
    step = {}

    def recording_fwd(fwd):
        def bn_fwd(act, eps, z, gamma, beta, res=None):
            out, mean, var, inv = fwd(act, eps, z, gamma, beta, res)
            zd = z.detach().reshape(-1, z.shape[-1]).double()
            m64 = zd.mean(0)
            v64 = ((zd - m64) ** 2).mean(0)
            step["blocks"].append({
                "C": z.shape[-1], "min_var": float(var.min()), "min_var64": float(v64.min()),
                "var_rel_err": float(((var.double() - v64).abs() / v64).max()),
                "mean2_over_var": float((m64 ** 2 / v64).max())})
            return out, mean, var, inv
        return bn_fwd

    def recording_score(self, labels, preout, mask=None):
        t = preout.detach().reshape(*preout.shape[:3], len(self.boxes), -1)
        step["wh_logits"] = [float(t[..., 2:4].min()), float(t[..., 2:4].max())]
        if preout.requires_grad:
            def hook(g):
                bad = ~torch.isfinite(g.reshape(t.shape))
                step["grad_nonfinite"] = int(bad.sum())
                step["grad_nonfinite_slots"] = sorted(
                    int(s) for s in bad.nonzero()[:, -1].unique().tolist())
            preout.register_hook(hook)
        return score(self, labels, preout, mask)

    Yolo2OutputLayer.compute_score = recording_score
    try:
        for seed, dtype, bn in RUNS:
            fwd, bwd = kernels[bn]
            bn_act.bn_act_fwd, bn_act.bn_act_bwd = recording_fwd(fwd), bwd
            x, y = cs.yolo_batch(torch, dev, cs.YOLO_BATCH, cs.YOLO_SIDE, cs.YOLO_CLASSES,
                                 seed=seed)
            ds = DataSet(x, y)
            net = MultiLayerNetwork(cs.yolo_conf(cs.YOLO_SIDE, dtype=dtype, renormalize=False),
                                    dev).init()
            steps = []
            for _ in range(STEPS):
                step.clear()
                step["blocks"] = []
                net.fit(ds)
                step["loss"] = float(net._score)
                step["nonfinite_layers"] = [
                    i for i, p in enumerate(net.params)
                    if any(not bool(torch.isfinite(v).all()) for v in p.values())]
                steps.append(dict(step))
            losses = [s["loss"] for s in steps]
            bad = next((i for i, v in enumerate(losses) if not np.isfinite(v)), None)
            last = steps[-1] if bad is None else steps[bad - 1]
            blocks = [b for s in steps for b in s["blocks"] if np.isfinite(b["min_var64"])]
            print(json.dumps({
                "seed": seed, "dtype": dtype, "bn": bn, "losses": losses,
                "first_nonfinite_step": bad,
                "min_var_by_step": [_finite(min(b["min_var"] for b in s["blocks"]))
                                    for s in steps],
                "max_var_rel_err": max(b["var_rel_err"] for b in blocks),
                "max_mean2_over_var": max(b["mean2_over_var"] for b in blocks),
                "last_finite_step": {"step": STEPS - 1 if bad is None else bad - 1,
                                     "blocks": last["blocks"],
                                     "wh_logits": last.get("wh_logits"),
                                     "grad_nonfinite": last.get("grad_nonfinite"),
                                     "grad_nonfinite_slots": last.get("grad_nonfinite_slots"),
                                     "nonfinite_layers_after": last["nonfinite_layers"]}}),
                flush=True)
            del net, ds
            torch.cuda.empty_cache()
    finally:
        Yolo2OutputLayer.compute_score = score
        bn_act.bn_act_fwd, bn_act.bn_act_bwd = kernels["kernel"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
