"""Serving fleet (counterpart of ``deeplearning4j_tpu/fleet``):
lease-backed replica set, health-aware router, and SLO-driven autoscaling.

The reference DL4J scales serving out with a fleet of Play servers over
a Spark cluster tier (SURVEY §2.11); this package composes the layers
this repo already has into the same shape, without a new control plane:

- **Membership = the elastic trainer's lease protocol**
  (:mod:`deeplearning4j_tpu_torch.parallel.leases`): each replica writes a
  TTL lease into a shared storage backend carrying its address, health,
  placement (models + retrieval indexes it hosts) and warmup state
  (``membership.py``).
- **Replica** = one :class:`~deeplearning4j_tpu_torch.serving.ModelServer`
  process wrapped with the lease announcer and an off-path warmup that
  only flips the lease to ``warmed`` once ``/readyz`` would pass — the
  router never routes to a cold replica (``replica.py``).
- **Router** = a front HTTP tier doing health-aware weighted routing
  over live leases with per-model AND per-index placement, forwarding
  the serving taxonomy (429/503/504) untouched, bounded per-replica
  connections, and backoff retry-on-transient against a DIFFERENT
  healthy replica — never retrying work a replica may have admitted
  unless the route is idempotent (``router.py``).
- **Autoscaler** = scale decisions driven by the SLO metrics ``obs/``
  already exports, scraped from each replica's ``/metrics``
  (``autoscaler.py``).

The port's replicas serve through its own ``ModelServer`` (the int4 and
int8 lowerings through ``int4_dot`` on the card), its leases, its
``CheckpointManager`` and ``backend_from_url``; leases and HTTP bodies are
the JAX package's, so a router of either package fronts replicas of both.
A fresh replica restores its checkpoint, warms off-path, then flips its
lease. A checkpoint carrying ``tuning.json`` restores its autotuner
``TuningRecord``, and the replica's endpoint warms the recorded ladder
(``ParallelInference(tuning=)``). The port compiles no programs, so there
is no compiled-program cache (``compile_cache_dir`` raises).
"""

from deeplearning4j_tpu_torch.fleet.membership import (REPLICA_PREFIX, FleetView,
                                                 ReplicaAnnouncer,
                                                 ReplicaInfo)
from deeplearning4j_tpu_torch.fleet.replica import ServingReplica, restore_and_serve
from deeplearning4j_tpu_torch.fleet.router import FleetRouter
from deeplearning4j_tpu_torch.fleet.autoscaler import (Autoscaler, AutoscalerPolicy,
                                                       histogram_quantile,
                                                       parse_prometheus)

__all__ = [
    "REPLICA_PREFIX", "ReplicaInfo", "ReplicaAnnouncer", "FleetView",
    "ServingReplica", "restore_and_serve", "FleetRouter",
    "Autoscaler", "AutoscalerPolicy", "parse_prometheus", "histogram_quantile",
]
