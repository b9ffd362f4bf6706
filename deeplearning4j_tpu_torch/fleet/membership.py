"""Fleet membership over the storage-backed lease protocol (counterpart of
``deeplearning4j_tpu/fleet/membership.py``; the same lease records).

Replicas and the router never talk to each other to discover the fleet:
both sides go through the same :class:`~deeplearning4j_tpu_torch.parallel.
leases.LeaseBoard` the elastic trainer uses, under a ``replica-`` key
prefix so a serving fleet and a training job can share one store
without colliding.

Write side — :class:`ReplicaAnnouncer`: one per replica process. The
lease payload carries

    {"address": "http://host:port",
     "models":  ["iris", ...],          # placement: models this replica hosts
     "indexes": ["docs", ...],          # ... and retrieval indexes
     "warmed":  bool,                   # every endpoint's ladder compiled
     "draining": bool,                  # shedding new work; going away
     "load":    {"inflight": int}}      # sampled at every heartbeat

``warmed`` starts False and is flipped by the replica only after its
server's readiness check passes — the router's never-route-to-cold
guarantee is this field, not a probe race.

Read side — :class:`FleetView`: parses live leases into
:class:`ReplicaInfo` records and answers placement queries
(``for_model``/``for_index``). Freshness uses the observer's clock
against the lease timestamp, same skew semantics as the trainer
(worst case: a live replica is briefly mis-declared dead and drops out
of routing until its next heartbeat — churn, never a wrong route).
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.parallel.leases import LeaseBoard

REPLICA_PREFIX = "replica-"

# serving replicas beat faster than trainer workers: routing reacts to a
# silent death within seconds, and the payload doubles as a load sample
DEFAULT_TTL_S = 5.0

__all__ = ["REPLICA_PREFIX", "DEFAULT_TTL_S", "ReplicaInfo",
           "ReplicaAnnouncer", "FleetView"]


@dataclasses.dataclass(frozen=True)
class ReplicaInfo:
    """One live replica, parsed from its lease."""
    replica_id: str
    address: str                  # base URL, e.g. "http://127.0.0.1:8401"
    warmed: bool
    draining: bool
    models: Tuple[str, ...]
    indexes: Tuple[str, ...]
    incarnation: str
    load: Dict[str, float]
    time: float                   # lease timestamp (writer's clock)

    @property
    def ready(self) -> bool:
        """Routable: warmed up and not going away."""
        return self.warmed and not self.draining

    @property
    def host_port(self) -> Tuple[str, int]:
        hostport = self.address.split("//", 1)[-1]
        host, _, port = hostport.partition(":")
        return host, int(port or 80)

    def hosts_model(self, name: str) -> bool:
        return name in self.models

    def hosts_index(self, name: str) -> bool:
        return name in self.indexes

    @classmethod
    def from_lease(cls, rec: dict) -> Optional["ReplicaInfo"]:
        """Parse a lease record; None for leases that aren't replica
        announcements (no address — e.g. a foreign writer)."""
        addr = rec.get("address")
        if not addr:
            return None
        return cls(replica_id=str(rec.get("worker_id", "")),
                   address=str(addr),
                   warmed=bool(rec.get("warmed", False)),
                   draining=bool(rec.get("draining", False)),
                   models=tuple(rec.get("models", ())),
                   indexes=tuple(rec.get("indexes", ())),
                   incarnation=str(rec.get("incarnation", "")),
                   load=dict(rec.get("load", {})),
                   time=float(rec.get("time", 0.0)))


class ReplicaAnnouncer:
    """The write side of fleet membership: one lease per replica.

    Placement and warmup state ride the lease as static payload fields
    (re-published on every heartbeat); ``load_fn`` is sampled at each
    write so the router/autoscaler see near-live load without extra
    round trips."""

    def __init__(self, store, replica_id: Optional[str] = None, *,
                 address: str, models: List[str] = (),
                 indexes: List[str] = (), ttl_s: float = DEFAULT_TTL_S,
                 heartbeat_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time,
                 load_fn: Optional[Callable[[], dict]] = None):
        self.replica_id = (replica_id if replica_id
                           else "r" + uuid.uuid4().hex[:8])
        self._load_fn = load_fn
        self.board = LeaseBoard(store, self.replica_id, ttl_s=ttl_s,
                                heartbeat_s=heartbeat_s, clock=clock,
                                prefix=REPLICA_PREFIX,
                                payload_fn=self._sample)
        self.board.set_payload(address=str(address),
                               models=list(models),
                               indexes=list(indexes),
                               warmed=False, draining=False)

    def _sample(self) -> dict:
        return {"load": dict(self._load_fn())} if self._load_fn else {}

    # ------------------------------------------------------------ lifecycle
    def announce(self):
        """Publish the lease now (warmed=False until :meth:`set_warmed`)
        and start the heartbeat."""
        self.board.write()
        self.board.start()
        return self

    def set_warmed(self, warmed: bool = True):
        self.board.set_payload(warmed=bool(warmed))
        self.board.write()

    def set_draining(self, draining: bool = True):
        self.board.set_payload(draining=bool(draining))
        self.board.write()

    def set_placement(self, models: Optional[List[str]] = None,
                      indexes: Optional[List[str]] = None):
        fields = {}
        if models is not None:
            fields["models"] = list(models)
        if indexes is not None:
            fields["indexes"] = list(indexes)
        if fields:
            self.board.set_payload(**fields)
            self.board.write()

    def withdraw(self):
        """Clean exit: stop the heartbeat and delete the lease so the
        router drops this replica immediately instead of after a TTL."""
        self.board.stop()
        self.board.withdraw()


class FleetView:
    """The read side: live replicas by placement. Never writes a lease."""

    def __init__(self, store, *, ttl_s: float = DEFAULT_TTL_S,
                 clock: Callable[[], float] = time.time):
        # a LeaseBoard that is never start()ed or write()n — used purely
        # for read_all()/is_fresh() so freshness semantics stay identical
        # to the trainer's
        self._board = LeaseBoard(store, "__fleet_view__", ttl_s=ttl_s,
                                 clock=clock, prefix=REPLICA_PREFIX)

    def replicas(self) -> Dict[str, ReplicaInfo]:
        """Every LIVE (fresh-leased) replica, by id."""
        out = {}
        for wid, rec in self._board.live().items():
            info = ReplicaInfo.from_lease(rec)
            if info is not None:
                out[wid] = info
        return out

    def ready(self, replicas: Optional[Dict[str, ReplicaInfo]] = None
              ) -> Dict[str, ReplicaInfo]:
        replicas = self.replicas() if replicas is None else replicas
        return {k: r for k, r in replicas.items() if r.ready}

    def for_model(self, name: str, *, ready_only: bool = True
                  ) -> List[ReplicaInfo]:
        rs = self.replicas()
        pool = self.ready(rs) if ready_only else rs
        return [r for r in pool.values() if r.hosts_model(name)]

    def for_index(self, name: str, *, ready_only: bool = True
                  ) -> List[ReplicaInfo]:
        rs = self.replicas()
        pool = self.ready(rs) if ready_only else rs
        return [r for r in pool.values() if r.hosts_index(name)]

    def snapshot(self) -> dict:
        """JSON-friendly topology dump (the router's ``/v1/fleet``)."""
        rs = self.replicas()
        return {"replicas": {k: dataclasses.asdict(r)
                             for k, r in sorted(rs.items())},
                "ready": sorted(self.ready(rs))}
