"""Offline post-training int8 quantization CLI (quant/ subsystem;
counterpart of the JAX package's ``tools/quantize.py``: the zip and the
report it writes are the JAX tool's, read by either package's
``restore``). It runs on ``cuda`` unless given ``--device cpu``.

Load a checkpoint (a ``CheckpointManager`` directory or a model zip), run
activation-range calibration from a dataset spec, lower to the int8
serving graph, and emit the quantized model zip + a calibration report::

    python -m deeplearning4j_tpu_torch.tools.quantize --ckpt /ckpts/mnist --out mnist_int8.zip \
        --data random:784 --batches 16 --batch-size 32 \
        --observer percentile --percentile 99.99

The quantized zip restores into the exact quantized predict
(``deeplearning4j_tpu_torch.utils.serialization.restore``) and can be served
directly. ``--save-calibration`` additionally drops ``calibration.json``
into the checkpoint DIRECTORY — that is what ``tools/serve.py --model
name=ckpt_dir --quantize`` (and ``python -m deeplearning4j_tpu_torch.serving``) reads to serve the int8 lowering live (and
re-apply it to every newer checkpoint the trainer commits).

Dataset specs (``--data``):

- ``random:<d0>x<d1>x...[@seed]`` — standard-normal batches of that
  per-example shape (e.g. ``random:784`` flat, ``random:28x28x1`` image)
- ``path.npz[:key]`` — an array from an .npz archive (default key ``x``)
- ``path.npy`` — a raw array; the leading axis is split into batches

Calibration data should be REPRESENTATIVE of serving traffic — random
data gives structurally valid scales for smoke tests, not accuracy-
preserving ones. ``--eval`` runs the accuracy gate (quant.accuracy_delta)
over the same stream when it carries labels (npz with ``y``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_net(path: str, device):
    if os.path.isdir(path):
        from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
        cm = CheckpointManager(path, device=device)
        try:
            net = cm.restore_latest(load_updater=False)
        finally:
            cm.close()
        if net is None:
            raise SystemExit(f"error: no restorable checkpoint in {path!r}")
        return net
    from deeplearning4j_tpu_torch.utils.serialization import restore
    return restore(path, device=device)


def param_bytes(net) -> int:
    """Total parameter bytes of a network (the JAX package's
    ``quant.param_bytes``: int8 weights shrink it about 4x)."""
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(net.params))


def parse_data_spec(spec: str, batches: int, batch_size: int):
    """Yield feature batches for a --data spec (see module docstring)."""
    if spec.startswith("random:"):
        body = spec[len("random:"):]
        seed = 0
        if "@" in body:
            body, seed_s = body.rsplit("@", 1)
            seed = int(seed_s)
        dims = tuple(int(d) for d in body.split("x"))
        rng = np.random.default_rng(seed)
        return [rng.standard_normal((batch_size,) + dims).astype(np.float32)
                for _ in range(batches)], None
    key = "x"
    path = spec
    if ":" in spec and not os.path.exists(spec):
        path, key = spec.rsplit(":", 1)
    if path.endswith(".npz"):
        with np.load(path) as z:
            x = np.asarray(z[key], np.float32)
            y = np.asarray(z["y"], np.float32) if "y" in z.files else None
    else:
        x = np.asarray(np.load(path), np.float32)
        y = None
    n = max(1, min(batches, -(-len(x) // batch_size)))
    xs = [x[i * batch_size:(i + 1) * batch_size] for i in range(n)]
    ys = (None if y is None else
          [y[i * batch_size:(i + 1) * batch_size] for i in range(n)])
    return [b for b in xs if len(b)], ys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True,
                   help="CheckpointManager directory or model zip to load")
    p.add_argument("--out", required=True, help="quantized model zip path")
    p.add_argument("--data", required=True,
                   help="calibration dataset spec (random:<dims>[@seed], "
                        ".npz[:key], .npy)")
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--observer", choices=("minmax", "percentile"),
                   default="minmax")
    p.add_argument("--percentile", type=float, default=99.99)
    p.add_argument("--report", default=None,
                   help="calibration report JSON path "
                        "(default: <out>.report.json)")
    p.add_argument("--save-calibration", action="store_true",
                   help="also write calibration.json into the checkpoint "
                        "directory (what tools/serve.py --quantize reads)")
    p.add_argument("--eval", action="store_true",
                   help="run the accuracy gate over the calibration "
                        "stream (needs labels: npz with 'y')")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.quant import calibrate, quantize
    from deeplearning4j_tpu_torch.quant.gates import accuracy_delta
    from deeplearning4j_tpu_torch.quant.lowering import quantized_layers
    from deeplearning4j_tpu_torch.utils.serialization import write_model

    net = _load_net(args.ckpt, resolve_device(args.device))
    xs, ys = parse_data_spec(args.data, args.batches, args.batch_size)
    record = calibrate(net, xs, observer=args.observer,
                       percentile=args.percentile)
    qnet = quantize(net, record)
    write_model(qnet, args.out, save_updater=False)

    fp32_bytes = param_bytes(net)
    q_bytes = param_bytes(qnet)
    report = {
        "source": args.ckpt,
        "out": args.out,
        "observer": args.observer,
        "percentile": (args.percentile if args.observer == "percentile"
                       else None),
        "calibration_batches": record.batches,
        "quantized_layers": [k for k, _ in quantized_layers(qnet)],
        "fp32_param_bytes": fp32_bytes,
        "quantized_param_bytes": q_bytes,
        "byte_reduction_x": round(fp32_bytes / max(q_bytes, 1), 2),
        "ranges": record.ranges,
    }
    if args.eval:
        if ys is None:
            print("warning: --eval needs labels (npz with 'y'); skipping "
                  "the accuracy gate", file=sys.stderr)
        else:
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet
            stream = [DataSet(x, y) for x, y in zip(xs, ys)]
            report["accuracy"] = accuracy_delta(net, qnet, stream)
    report_path = args.report or (args.out + ".report.json")
    with open(report_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    if args.save_calibration:
        if os.path.isdir(args.ckpt):
            record.save(os.path.join(args.ckpt, "calibration.json"))
        else:
            print("warning: --save-calibration needs --ckpt to be a "
                  "checkpoint DIRECTORY (tools/serve.py --quantize reads "
                  "calibration.json from there); nothing written for "
                  f"model zip {args.ckpt!r}", file=sys.stderr)
    print(json.dumps({
        "quantized": len(report["quantized_layers"]),
        "byte_reduction_x": report["byte_reduction_x"],
        "out": args.out, "report": report_path,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
