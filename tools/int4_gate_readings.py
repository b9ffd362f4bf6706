#!/usr/bin/env python3
"""Readings of chip_smoke.py's int4 gate on LeNet: the sound lowering
against controls that drop part of each int4 layer's inputs.

    python3 tools/int4_gate_readings.py [--device cpu] [--steps 20,200,938,1876]

Trains LeNet (BASELINE configs[0], Adam 1e-3, batch 64) through
MultiLayerNetwork.fit on mnist_data's seeded synthetic training set with
its pixels rounded to 1/255 (as the idx files of the lenet_gates phase
hold them). At each step count it calibrates on 4 training batches,
lowers with quantize(weight_bits=4) and runs accuracy_delta over the
10,000 test examples in batches of 100, once with the int4_dot wrapper as
it is ("sound") and once for each control, where the wrapper zeroes the
last 32 or 64 inputs of every int4 product ("tail32", "tail64"; a kernel
that lost its last k tile computes that). Prints one JSON line per step
count: for each reading the two top-1 accuracies, the agreement, both
mean NLLs, the absolute and the relative loss delta. The device follows
the port's rule: the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from deeplearning4j_tpu_torch.datasets import DataSet, mnist_data  # noqa: E402
from deeplearning4j_tpu_torch.models import LeNet  # noqa: E402
from deeplearning4j_tpu_torch.perf.kernels import int4_dot  # noqa: E402
from deeplearning4j_tpu_torch.quant import calibrate, quantize  # noqa: E402
from deeplearning4j_tpu_torch.quant.gates import accuracy_delta  # noqa: E402

BATCH, VAL_BATCH, CALIB_BATCHES = 64, 100, 4


def _tail_dropped(kernel, n):
    def run(qq, packed, d):
        qq = qq.clone()
        qq[:, -n:] = 0
        return kernel(qq, packed, d)
    return run


def readings(net, q, val) -> dict:
    kernel = int4_dot.int4_matmul
    out = {}
    for name, fn in (("sound", kernel), ("tail32", _tail_dropped(kernel, 32)),
                     ("tail64", _tail_dropped(kernel, 64))):
        int4_dot.int4_matmul = fn
        try:
            r = accuracy_delta(net, q, val)
        finally:
            int4_dot.int4_matmul = kernel
        out[name] = {k: r[k] for k in ("fp32_top1", "quant_top1", "top1_agreement",
                                       "fp32_loss", "quant_loss", "loss_delta_rel")}
        out[name]["loss_delta_abs"] = abs(r["quant_loss"] - r["fp32_loss"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", default="20,200,938,1876")
    args = ap.parse_args()
    marks = sorted(int(s) for s in args.steps.split(","))
    x, y = mnist_data(60000, train=True)
    xt, yt = mnist_data(10000, train=False)
    x = (np.rint(x * 255.0) / 255.0).astype(np.float32)
    xt = (np.rint(xt * 255.0) / 255.0).astype(np.float32)
    val = [DataSet(xt[i:i + VAL_BATCH], yt[i:i + VAL_BATCH]) for i in range(0, len(xt), VAL_BATCH)]
    net = LeNet().init(args.device)
    per_epoch = len(x) // BATCH
    step = 0
    for mark in marks:
        while step < mark:
            i = (step % per_epoch) * BATCH
            net.fit(DataSet(x[i:i + BATCH], y[i:i + BATCH]))
            step += 1
        calib = [x[j * BATCH:(j + 1) * BATCH] for j in range(CALIB_BATCHES)]
        q = quantize(net, calibrate(net, calib), weight_bits=4)
        print("int4_gate_readings " + json.dumps({
            "device": str(net.device), "steps": step, **readings(net, q, val)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
