"""One fleet replica: a ModelServer wrapped with lease membership and
off-path warmup (counterpart of ``deeplearning4j_tpu/fleet/replica.py``).

Lifecycle:

1. ``start()`` binds the HTTP port and immediately announces a lease
   with ``warmed=False`` — the fleet sees the replica exists but the
   router will not route to it.
2. Warmup runs OFF-PATH on a daemon thread: every endpoint's bucket
   ladder dispatches once. Only when the server's own readiness check
   passes does the lease flip to ``warmed=True``.
3. ``stop()`` marks the lease draining, withdraws it (so the router
   drops the replica immediately, not after a TTL), then drains the
   server — every admitted request completes.

:func:`restore_and_serve` is the subprocess entrypoint (used by
``python -m deeplearning4j_tpu_torch.fleet replica``): restore each
model's latest checkpoint onto the replica's device and serve it; a
checkpoint carrying a calibration record (``quantization.json``) serves
its int8 or int4 lowering when ``weight_bits`` asks for one.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

from deeplearning4j_tpu_torch.fleet.membership import (DEFAULT_TTL_S,
                                                 ReplicaAnnouncer)

log = logging.getLogger(__name__)

__all__ = ["ServingReplica", "restore_and_serve"]


class ServingReplica:
    """Couples a :class:`~deeplearning4j_tpu_torch.serving.ModelServer` to the
    fleet lease board. The server must have its models/indexes registered
    before ``start()`` — placement is published from its endpoint maps."""

    def __init__(self, server, store, replica_id: Optional[str] = None, *,
                 ttl_s: float = DEFAULT_TTL_S,
                 heartbeat_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self.server = server
        self._store = store
        self._ttl_s = ttl_s
        self._heartbeat_s = heartbeat_s
        self._clock = clock
        self._replica_id = replica_id
        self.announcer: Optional[ReplicaAnnouncer] = None
        self._warm_thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._stopped = False

    # --------------------------------------------------------------- state
    @property
    def replica_id(self) -> str:
        return self.announcer.replica_id if self.announcer \
            else (self._replica_id or "")

    @property
    def address(self) -> str:
        return self.server.address

    def _load(self) -> dict:
        return {"inflight": self.server.inflight}

    # ----------------------------------------------------------- lifecycle
    def start(self, warm: bool = True) -> "ServingReplica":
        """Bind, announce (warmed=False), then warm off-path; the lease
        flips to warmed only when readiness passes. ``warm=False`` leaves
        the flip to a later explicit :meth:`mark_ready` (tests)."""
        self.server.start(warmup=False)
        self._seed_feature_shapes()
        self.announcer = ReplicaAnnouncer(
            self._store, self._replica_id, address=self.server.address,
            models=sorted(self.server.endpoints),
            indexes=sorted(self.server.indexes),
            ttl_s=self._ttl_s, heartbeat_s=self._heartbeat_s,
            clock=self._clock, load_fn=self._load)
        self.announcer.announce()
        if warm:
            self._warm_thread = threading.Thread(
                target=self._warm_and_flip,
                name=f"replica-warmup-{self.replica_id}", daemon=True)
            self._warm_thread.start()
        return self

    def _seed_feature_shapes(self):
        """Endpoints registered without a warmup example learn their
        feature-shape guard from the first SUCCESSFUL request — on a
        fresh replica a wrong-shaped request would reach dispatch and
        500. Seed the guard from the conf-described input shape so it
        400s pre-dispatch."""
        for ep in self.server.endpoints.values():
            if getattr(ep, "feature_shape", None) is not None:
                continue
            ex = ep.pi._tuning_example()
            if ex is not None:
                ep.feature_shape = tuple(ex.shape[1:])

    def _warm_and_flip(self):
        try:
            self.server.warmup()
        except Exception:
            log.exception("replica %s warmup failed; lease stays cold",
                          self.replica_id)
        ready, reasons = self.server.readiness()
        if ready:
            self.mark_ready()
        else:
            # an endpoint failed warmup: the replica stays registered but
            # cold — visible in /v1/fleet, never routed to
            log.warning("replica %s not ready after warmup: %s",
                        self.replica_id, reasons)

    def mark_ready(self):
        """Flip the lease to warmed — the router may now route here."""
        self.announcer.set_warmed(True)
        self._ready.set()

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        return self._ready.wait(timeout_s)

    def stop(self, drain_timeout_s: float = 30.0):
        """Drain-clean exit: lease goes draining→withdrawn FIRST (the
        router stops sending work immediately), then the server drains so
        everything already admitted completes."""
        if self._stopped:
            return
        self._stopped = True
        if self.announcer is not None:
            self.announcer.set_draining(True)
            self.announcer.withdraw()
        self.server.stop(drain=True, drain_timeout_s=drain_timeout_s)


def restore_and_serve(store, models: List[Tuple[str, str]], *,
                      indexes: List[Tuple[str, object]] = (),
                      replica_id: Optional[str] = None, port: int = 0,
                      bind_address: str = "127.0.0.1",
                      queue_depth: int = 256, batch_limit: int = 32,
                      default_deadline_ms: float = 1000.0,
                      poll_secs: Optional[float] = None,
                      ttl_s: float = DEFAULT_TTL_S,
                      wait_ready_s: float = 300.0,
                      compile_cache_dir: Optional[str] = None,
                      cache_dir: Optional[str] = None,
                      weight_bits: Optional[int] = None,
                      device=None) -> "ServingReplica":
    """Subprocess-shaped replica bring-up: restore each ``(name,
    ckpt_target)`` model's latest checkpoint onto ``device`` (the card
    unless ``"cpu"``), register everything on a fresh ModelServer, start
    and announce. Returns the running replica; the caller owns the
    lifetime (``stop()``).

    ``ckpt_target`` is a local directory OR a backend URL
    (``http(s)://host:port/bucket``, ``mem:[name]``, ``file:/path`` —
    see :func:`~deeplearning4j_tpu_torch.checkpoint.cloud.backend_from_url`):
    a URL target restores straight from the data lake. ``cache_dir``
    wraps URL targets in a :class:`CachedBackend` so a restarted replica
    re-reads its checkpoint bytes from local disk instead of the wire.

    ``weight_bits`` (8 or 4) serves each model whose checkpoint carries a
    calibration record as that record's int8 lowering with weights of that
    width (``ModelServer.add_model(quantize=, weight_bits=)``); a model
    without a record raises. None serves the restored network as it is,
    as the JAX package does.

    A checkpoint carrying an autotuner ``TuningRecord`` (``tuning.json``)
    restores with it, and its endpoint's ``ParallelInference`` inherits it:
    the record is checked against the network and its ladder warmed.

    ``compile_cache_dir`` raises ``NotImplementedError``: it points JAX's
    persistent compilation cache at a directory, and the port compiles no
    programs to keep."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.checkpoint.cloud import backend_from_url
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.serving import ModelServer

    dev = resolve_device(device)

    server = ModelServer(port=port, bind_address=bind_address,
                         queue_depth=queue_depth, batch_limit=batch_limit,
                         default_deadline_ms=default_deadline_ms,
                         compile_cache_dir=compile_cache_dir)
    managers = []
    for name, ckpt_dir in models:
        if "://" in ckpt_dir or ckpt_dir.startswith("mem:"):
            backend = backend_from_url(ckpt_dir, cache_dir=cache_dir)
            cm = CheckpointManager(storage=backend, device=dev)
        else:
            cm = CheckpointManager(ckpt_dir, device=dev)
        managers.append(cm)
        net = cm.restore_latest(load_updater=False)
        if net is None:
            raise FileNotFoundError(
                f"no restorable checkpoint in {ckpt_dir!r} for '{name}'")
        quant = {}
        if weight_bits is not None:
            record = getattr(net, "_quant_calibration", None)
            if record is None:
                raise ValueError(f"restore_and_serve(weight_bits={weight_bits}): the "
                                 f"checkpoint of '{name}' carries no calibration record "
                                 "(quantization.json)")
            quant = {"quantize": record, "weight_bits": int(weight_bits)}
        server.add_model(name, net, checkpoint_manager=cm,
                         checkpoint_poll_secs=poll_secs, **quant)
    for name, index in indexes:
        server.add_index(name, index)

    replica = ServingReplica(server, store, replica_id, ttl_s=ttl_s)
    replica._managers = managers  # closed with the process
    replica.start()
    if wait_ready_s:
        replica.wait_ready(wait_ready_s)
    return replica
