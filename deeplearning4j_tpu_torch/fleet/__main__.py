"""``python -m deeplearning4j_tpu_torch.fleet``: run a local serving fleet of
the PyTorch port (counterpart of the JAX package's ``tools/fleet.py``, the
same subcommands and flags): router + N checkpoint-serving replicas over a
shared lease store.

    # one command: router on :9200, 2 replicas, shared store directory
    python -m deeplearning4j_tpu_torch.fleet up --replicas 2 \
        --model iris=/ckpts/iris --store /tmp/fleet --router-port 9200

    curl -s localhost:9200/readyz
    curl -s -X POST localhost:9200/v1/models/iris:predict \
        -d '{"inputs": [[5.1, 3.5, 1.4, 0.2]]}'
    curl -s localhost:9200/v1/fleet          # topology: leases + placement

Replicas restore each model's latest checkpoint on the card (``--device
cpu`` for the CPU) and warm before the lease flips ready; ``--weight-bits``
8 or 4 serves a checkpoint's calibration record as its quantized lowering.
SIGTERM anywhere drains: replicas withdraw their lease FIRST (the router
stops routing immediately), then finish every admitted request; the router
stops accepting after its replicas exit.

Subcommands ``router`` and ``replica`` run a single process each (what
``up`` spawns; also the chaos tests' SIGKILL targets). ``smoke`` runs an
in-process end-to-end check with no checkpoints needed.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request


def _parse_model(spec: str):
    name, sep, path = spec.partition("=")
    if not sep or not name or not path:
        raise argparse.ArgumentTypeError(
            f"--model takes name=checkpoint_dir; got {spec!r}")
    return name, path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, models_required=True):
        sp.add_argument("--store", required=True,
                        help="shared lease/membership store directory")
        if models_required:
            sp.add_argument("--model", action="append", type=_parse_model,
                            required=True, metavar="NAME=CKPT_DIR")
        sp.add_argument("--ttl-s", type=float, default=5.0,
                        help="replica lease TTL")
        sp.add_argument("--drain-timeout-s", type=float, default=30.0)
        sp.add_argument("--device", default=None, help="cuda (default) or cpu")

    up = sub.add_parser("up", help="router + N replica subprocesses")
    common(up)
    up.add_argument("--replicas", type=int, default=2)
    up.add_argument("--router-port", type=int, default=9200)
    up.add_argument("--bind", default="127.0.0.1")
    up.add_argument("--poll-secs", type=float, default=None,
                    help="checkpoint hot-swap poll cadence per replica")
    up.add_argument("--weight-bits", type=int, default=None, choices=(8, 4),
                    help="replicas serve the checkpoints' quantized lowering")

    rep = sub.add_parser("replica", help="one replica process")
    common(rep)
    rep.add_argument("--replica-id", default=None)
    rep.add_argument("--port", type=int, default=0)
    rep.add_argument("--bind", default="127.0.0.1")
    rep.add_argument("--poll-secs", type=float, default=None)
    rep.add_argument("--weight-bits", type=int, default=None, choices=(8, 4),
                     help="serve each checkpoint's calibration record as its "
                          "quantized lowering with weights of this width")

    rt = sub.add_parser("router", help="one router process")
    common(rt, models_required=False)
    rt.add_argument("--port", type=int, default=9200)
    rt.add_argument("--bind", default="127.0.0.1")

    sm = sub.add_parser("smoke", help="in-process end-to-end fleet check")
    sm.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def _wait_for_signal(on_signal=None) -> threading.Event:
    done = threading.Event()

    def _handler(signum, frame):
        if on_signal:
            on_signal(signum)
        done.set()
    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
    return done


# ------------------------------------------------------------------ replica
def cmd_replica(args) -> int:
    from deeplearning4j_tpu_torch.fleet.replica import restore_and_serve
    replica = restore_and_serve(
        args.store, list(args.model), replica_id=args.replica_id,
        port=args.port, bind_address=args.bind, poll_secs=args.poll_secs,
        ttl_s=args.ttl_s, wait_ready_s=0, weight_bits=args.weight_bits,
        device=args.device)
    done = _wait_for_signal(
        lambda s: print(f"replica {replica.replica_id}: signal {s}, "
                        f"draining ({replica.server.inflight} in flight)",
                        flush=True))
    replica.wait_ready(300.0)
    print(f"replica {replica.replica_id} ready on {replica.address} "
          f"(models: {sorted(replica.server.endpoints)})", flush=True)
    done.wait()
    replica.stop(drain_timeout_s=args.drain_timeout_s)
    print(f"replica {replica.replica_id}: drained and stopped.",
          flush=True)
    return 0


# ------------------------------------------------------------------- router
def cmd_router(args) -> int:
    from deeplearning4j_tpu_torch.fleet import FleetRouter, FleetView
    view = FleetView(args.store, ttl_s=args.ttl_s)
    router = FleetRouter(view, port=args.port,
                         bind_address=args.bind).start()
    print(f"fleet router on {router.address} (store: {args.store})",
          flush=True)
    done = _wait_for_signal(
        lambda s: print(f"router: signal {s}, stopping", flush=True))
    done.wait()
    router.stop()
    print("router stopped.", flush=True)
    return 0


# ----------------------------------------------------------------------- up
def cmd_up(args) -> int:
    from deeplearning4j_tpu_torch.fleet import FleetRouter, FleetView

    procs = []
    for i in range(args.replicas):
        cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.fleet", "replica",
               "--store", args.store, "--replica-id", f"rep{i}", "--ttl-s", str(args.ttl_s),
               "--drain-timeout-s", str(args.drain_timeout_s)]
        for name, ckpt in args.model:
            cmd += ["--model", f"{name}={ckpt}"]
        if args.poll_secs is not None:
            cmd += ["--poll-secs", str(args.poll_secs)]
        if args.weight_bits is not None:
            cmd += ["--weight-bits", str(args.weight_bits)]
        if args.device is not None:
            cmd += ["--device", args.device]
        procs.append(subprocess.Popen(cmd))
    view = FleetView(args.store, ttl_s=args.ttl_s)
    router = FleetRouter(view, port=args.router_port,
                         bind_address=args.bind).start()
    print(f"fleet router on {router.address}; {args.replicas} replica(s) "
          "warming (readyz flips when the first lease is warmed)",
          flush=True)

    done = _wait_for_signal(
        lambda s: print(f"fleet: signal {s}, draining replicas",
                        flush=True))
    done.wait()
    # drain order: replicas first (each withdraws its lease, finishes
    # admitted work), router last — admitted requests complete, the
    # router 503s anything arriving after the last lease is gone
    for p in procs:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + args.drain_timeout_s + 30.0
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
    router.stop()
    print("fleet stopped.", flush=True)
    return 0


# -------------------------------------------------------------------- smoke
def cmd_smoke(args) -> int:
    """In-process end-to-end: 2 replicas on an in-memory store, health-
    aware routing, retry-over-replica-death. No checkpoints required."""
    import numpy as np

    from deeplearning4j_tpu_torch.checkpoint.storage import ObjectStoreBackend
    from deeplearning4j_tpu_torch.fleet import FleetRouter, FleetView, ServingReplica
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.serving import ModelServer

    def _net(seed):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Sgd(learning_rate=0.05)).weight_init("xavier")
                .list()
                .layer(DenseLayer(n_out=8, activation="tanh"))
                .layer(OutputLayer(n_out=3, loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        return MultiLayerNetwork(conf, device=args.device).init()

    store = ObjectStoreBackend()
    example = np.zeros((4, 4), np.float32)
    replicas = []
    try:
        for i in range(2):
            srv = ModelServer(port=0)
            srv.add_model("smoke", _net(i), warmup_example=example)
            replicas.append(ServingReplica(
                srv, store, f"smoke{i}", ttl_s=5.0,
                heartbeat_s=0.5).start())
        for r in replicas:
            assert r.wait_ready(120), "replica never warmed"
        router = FleetRouter(FleetView(store), refresh_s=0.1,
                             seed=0).start()
        try:
            body = json.dumps(
                {"inputs": [[5.1, 3.5, 1.4, 0.2]]}).encode()
            req = urllib.request.Request(
                router.address + "/v1/models/smoke:predict", data=body,
                headers={"Content-Type": "application/json"})
            for _ in range(3):
                with urllib.request.urlopen(req, timeout=15) as resp:
                    assert resp.status == 200
            # ungraceful replica death: routing retries to the survivor
            replicas[0].server.stop(drain=False)
            with urllib.request.urlopen(req, timeout=15) as resp:
                assert resp.status == 200
            with urllib.request.urlopen(router.address + "/v1/fleet",
                                        timeout=5) as resp:
                assert resp.status == 200
        finally:
            router.stop()
    finally:
        for r in replicas:
            try:
                r.stop(drain_timeout_s=5.0)
            except Exception:
                pass
    print("fleet smoke: OK", flush=True)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"up": cmd_up, "replica": cmd_replica,
            "router": cmd_router, "smoke": cmd_smoke}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
