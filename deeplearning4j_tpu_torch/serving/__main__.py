"""Serve checkpointed models over HTTP: ``ModelServer`` from the command
line (counterpart of the JAX package's ``tools/serve.py``).

Restores each model's latest committed checkpoint through the port's
``CheckpointManager``, serves it behind the overload-safe front-end, keeps
polling the store so a training job's newer commits hot-swap in live, and
drains on SIGTERM (or SIGINT)::

    python -m deeplearning4j_tpu_torch.serving --model iris=/ckpts/iris \\
        --port 9100 --poll-secs 10 --queue-depth 256 --deadline-ms 250

Then::

    curl -s localhost:9100/readyz
    curl -s -X POST localhost:9100/v1/models/iris:predict \\
        -d '{"inputs": [[5.1, 3.5, 1.4, 0.2]], "deadline_ms": 100}'
    curl -s localhost:9100/metrics | grep serving_

Models run on the card unless ``--device cpu`` is given. ``--port 0``
binds a free port; the address is printed on the ``serving`` line.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _parse_model(spec: str):
    name, sep, path = spec.partition("=")
    if not sep or not name or not path:
        raise argparse.ArgumentTypeError(
            f"--model takes name=checkpoint_dir; got {spec!r}")
    return name, path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m deeplearning4j_tpu_torch.serving",
                                description=__doc__.splitlines()[0])
    p.add_argument("--model", action="append", type=_parse_model,
                   default=[], metavar="NAME=CKPT_DIR",
                   help="model name + checkpoint directory (repeatable: "
                        "several nets behind one server)")
    p.add_argument("--generate", action="append", type=_parse_model,
                   default=[], metavar="NAME=CKPT_DIR",
                   help="generative (stateful RNN) model to serve behind "
                        "POST /v1/models/NAME:generate with token streaming "
                        "(repeatable); hot-swaps with --poll-secs like --model")
    p.add_argument("--port", type=int, default=9100)
    p.add_argument("--bind", default="127.0.0.1",
                   help="bind address (default loopback; 0.0.0.0 to serve "
                        "remotely)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--queue-depth", type=int, default=256,
                   help="admission queue bound per model (full ⇒ 429)")
    p.add_argument("--deadline-ms", type=float, default=1000.0,
                   help="default per-request deadline")
    p.add_argument("--batch-limit", type=int, default=32,
                   help="max coalesced requests per dispatch")
    p.add_argument("--poll-secs", type=float, default=None,
                   help="checkpoint hot-swap poll cadence (off when unset)")
    p.add_argument("--fold-bn", action="store_true",
                   help="serve BN-folded copies (perf.fusion.fold_bn)")
    p.add_argument("--quantize", action="store_true",
                   help="serve quantized copies (quant/): each model's "
                        "checkpoint dir must hold a calibration.json; "
                        "hot-swapped checkpoints are re-quantized with the "
                        "same record")
    p.add_argument("--weight-bits", type=int, default=8, choices=(4, 8),
                   help="weight grid of --quantize (4: packed int4 through "
                        "the int4_dot kernel)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.model and not args.generate:
        print("error: need at least one --model or --generate", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.serving import ModelServer

    server = ModelServer(port=args.port, bind_address=args.bind,
                         default_deadline_ms=args.deadline_ms,
                         queue_depth=args.queue_depth,
                         batch_limit=args.batch_limit)
    managers = []
    for name, ckpt_dir in args.model:
        cm = CheckpointManager(ckpt_dir, device=args.device)
        managers.append(cm)
        net = cm.restore_latest(load_updater=False)
        if net is None:
            print(f"error: no restorable checkpoint in {ckpt_dir!r} "
                  f"for model '{name}'", file=sys.stderr)
            return 2
        record = None
        if args.quantize:
            from deeplearning4j_tpu_torch.quant import CalibrationRecord
            cal_path = os.path.join(ckpt_dir, "calibration.json")
            if not os.path.exists(cal_path):
                print(f"error: --quantize needs {cal_path!r} (a "
                      "CalibrationRecord saved beside the checkpoints)",
                      file=sys.stderr)
                return 2
            record = CalibrationRecord.load(cal_path)
        try:
            server.add_model(name, net, fold_bn=args.fold_bn, quantize=record,
                             weight_bits=args.weight_bits, checkpoint_manager=cm,
                             checkpoint_poll_secs=args.poll_secs)
        except (ValueError, TypeError) as e:
            print(f"error: cannot serve model '{name}': {e}", file=sys.stderr)
            return 2
        print(f"model '{name}': serving checkpoint step "
              f"{net._restored_from.step} from {ckpt_dir}"
              + (f" (int{args.weight_bits}-quantized)" if record is not None else ""),
              flush=True)

    for name, ckpt_dir in args.generate:
        cm = CheckpointManager(ckpt_dir, device=args.device)
        managers.append(cm)
        net = cm.restore_latest(load_updater=False)
        if net is None:
            print(f"error: no restorable checkpoint in {ckpt_dir!r} "
                  f"for generator '{name}'", file=sys.stderr)
            return 2
        try:
            server.add_generator(name, net,
                                 checkpoint_manager=cm if args.poll_secs else None,
                                 checkpoint_poll_secs=args.poll_secs)
        except (ValueError, TypeError) as e:
            print(f"error: cannot serve generator '{name}': {e}", file=sys.stderr)
            return 2
        print(f"generator '{name}': serving checkpoint step "
              f"{net._restored_from.step} from {ckpt_dir}", flush=True)

    # predict endpoints have no example shape on file (a cold first
    # request); decode slot ladders do warm — async, gating /readyz
    server.start(warmup=bool(server.generators))
    print(f"serving {len(server.endpoints)} model(s) + "
          f"{len(server.generators)} generator(s) on {server.address} "
          f"(hot-swap {'every %gs' % args.poll_secs if args.poll_secs else 'off'})",
          flush=True)

    done = threading.Event()

    def _shutdown(signum, frame):
        print(f"signal {signum}: draining ({server.inflight} in flight)...", flush=True)
        done.set()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    done.wait()
    server.stop(drain=True, drain_timeout_s=args.drain_timeout_s)
    for cm in managers:
        cm.close()
    print("drained and stopped.", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
