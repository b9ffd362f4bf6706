"""Offline memory-planner + autotuner CLI (perf/ subsystem; counterpart
of the JAX package's ``tools/autotune.py``, whose ``TuningRecord`` JSON it
writes). The estimates run on the meta device and the top candidates are
timed on ``cuda`` unless given ``--device cpu``.

Load a model (a ``CheckpointManager`` directory, a model zip, or a zoo
model by name), search batch size / fusion / donation — and, with
``--budget``, per-layer remat policies under the stated HBM budget — then
write the winning ``TuningRecord`` as JSON::

    python -m deeplearning4j_tpu_torch.tools.autotune --model zoo:lenet --batch-sizes 8,16,32 \
        --budget 512M --out lenet.tuning.json --report

The record is what the rest of the stack consumes:

- ``perf.autotune.build_network(conf, record)`` / ``apply_tuning`` — a
  fresh training replica inherits the tuned conf + batch size;
- ``ParallelInference(tuning=record)`` / ``ModelServer.add_model(
  tuning=record)`` — a serving endpoint adopts the recorded bucket ladder,
  warmed at registration (zero compiles at serve time);
- models saved with the record attached carry ``tuning.json`` in their
  zip/checkpoints, so restores inherit it automatically.

``--save-into-ckpt`` drops ``tuning.json`` into the checkpoint DIRECTORY
next to the checkpoints (the ``calibration.json`` convention from
the quantize tool). Budgets accept ``K``/``M``/``G`` suffixes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ZOO = ("lenet", "simplecnn", "alexnet", "vgg16", "resnet50", "darknet19",
        "googlenet")


def _load_conf(spec: str, device):
    """Configuration for --model: ``zoo:<name>[:<h>x<w>x<c>]``, a
    CheckpointManager directory, or a model zip."""
    if spec.startswith("zoo:"):
        parts = spec.split(":")
        name = parts[1].lower()
        shape = None
        if len(parts) > 2:
            shape = tuple(int(d) for d in parts[2].split("x"))
        from deeplearning4j_tpu_torch import models
        cls = {"lenet": models.LeNet, "simplecnn": models.SimpleCNN,
               "alexnet": models.AlexNet, "vgg16": models.VGG16,
               "resnet50": models.ResNet50, "darknet19": models.Darknet19,
               "googlenet": models.GoogLeNet}.get(name)
        if cls is None:
            raise SystemExit(f"error: unknown zoo model '{name}' "
                             f"(known: {', '.join(_ZOO)})")
        kw = {"num_classes": 10}
        if shape is not None:
            kw["input_shape"] = shape
        try:
            return cls(**kw).conf()
        except TypeError:  # models without input_shape (LeNet)
            return cls(num_classes=10).conf()
    if os.path.isdir(spec):
        from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
        cm = CheckpointManager(spec, device=device)
        try:
            net = cm.restore_latest(load_updater=False)
        finally:
            cm.close()
        if net is None:
            raise SystemExit(f"error: no restorable checkpoint in {spec!r}")
        return net.conf
    from deeplearning4j_tpu_torch.utils.serialization import restore
    return restore(spec, device=device).conf


def parse_bytes(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suffix, m in (("K", 2**10), ("M", 2**20), ("G", 2**30)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True,
                   help="zoo:<name>[:<HxWxC>], a CheckpointManager "
                        "directory, or a model zip")
    p.add_argument("--out", required=True, help="TuningRecord JSON path")
    p.add_argument("--batch-sizes", default="8,16,32",
                   help="comma list of candidate training batch sizes")
    p.add_argument("--budget", default=None,
                   help="HBM budget (bytes; K/M/G suffixes) — enables the "
                        "memory planner (per-layer remat search)")
    p.add_argument("--fusion", choices=("auto", "on", "off"), default="auto")
    p.add_argument("--no-donation-search", action="store_true",
                   help="only search donate=True (the default execution)")
    p.add_argument("--top-k", type=int, default=2,
                   help="candidates to wall-clock confirm")
    p.add_argument("--reps", type=int, default=2,
                   help="timed repetitions per confirmed candidate")
    p.add_argument("--max-serving-batch", type=int, default=None,
                   help="top of the recorded serving bucket ladder "
                        "(default: the chosen batch size)")
    p.add_argument("--serving-rows", default=None,
                   help="comma list of observed serving row counts — "
                        "learns the ladder from the histogram instead of "
                        "the pow2 default")
    p.add_argument("--plan-only", action="store_true",
                   help="run the HBM planner only (needs --budget); print "
                        "the plan, write no record")
    p.add_argument("--save-into-ckpt", action="store_true",
                   help="also write tuning.json into the checkpoint "
                        "directory (--model must be a directory)")
    p.add_argument("--report", action="store_true",
                   help="print the full record JSON instead of the "
                        "one-line summary")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu: where the top "
                        "candidates are timed")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.perf.autotune import autotune
    from deeplearning4j_tpu_torch.perf.planner import plan_memory

    device = resolve_device(args.device)
    conf = _load_conf(args.model, device)
    budget = None if args.budget is None else parse_bytes(args.budget)
    batch_sizes = tuple(int(b) for b in args.batch_sizes.split(",") if b)
    fusion = {"auto": "auto", "on": True, "off": False}[args.fusion]

    if args.plan_only:
        if budget is None:
            raise SystemExit("error: --plan-only needs --budget")
        plan = plan_memory(conf, budget, minibatch=max(batch_sizes),
                           fusion=fusion)
        print(plan.summary())
        return 0

    serving_rows = (None if args.serving_rows is None else
                    [int(r) for r in args.serving_rows.split(",") if r])
    record = autotune(
        conf, batch_sizes=batch_sizes, fusion=fusion,
        donation=((True,) if args.no_donation_search else (True, False)),
        budget_bytes=budget, top_k=args.top_k, reps=args.reps,
        serving_rows=serving_rows,
        max_serving_batch=args.max_serving_batch, device=device)
    record.save(args.out)
    if args.save_into_ckpt:
        if os.path.isdir(args.model):
            record.save(os.path.join(args.model, "tuning.json"))
        else:
            print("warning: --save-into-ckpt needs --model to be a "
                  "checkpoint DIRECTORY; nothing written for "
                  f"{args.model!r}", file=sys.stderr)
    if args.report:
        print(json.dumps(record.to_dict(), indent=2, sort_keys=True))
    else:
        print(json.dumps({
            "out": args.out,
            "batch_size": record.batch_size,
            "fusion": record.fusion,
            "donate": record.donate,
            "remat_layers": len(record.remat),
            "buckets": list(record.buckets),
            "step_seconds": record.objective.get("step_seconds"),
            "candidates": record.candidates_searched,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
