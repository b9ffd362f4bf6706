"""Elastic cluster training (counterpart of
``deeplearning4j_tpu/parallel/elastic.py``): membership changes at epoch
boundaries survive worker death, arrival and whole-job preemption.

- **Rendezvous over storage, not a new network service.** Workers
  coordinate through a :class:`~deeplearning4j_tpu_torch.checkpoint.
  storage.StorageBackend` (the medium the checkpoints ride): per-worker
  **lease** objects refreshed by a heartbeat thread
  (``parallel/leases.py``), immutable **membership records** (``gen-N``)
  and **bump** breadcrumbs asking for a generation's supersession. The
  records are the JAX package's JSON, so either package's fleet reads the
  other's. The membership for generation N+1 forms once every live lease
  has either joined the barrier (``barrier >= N+1``) or expired: a dead
  worker delays the bump by at most one TTL.
- **Leader = smallest live worker id.** The leader writes the membership
  record, naming a fresh port (``_pick_free_port``) on which, as rank 0,
  it hosts the generation's ``torch.distributed`` store. After writing,
  everyone adopts the record the store actually holds; a worker the
  record excludes rejoins at the next generation. That, and
  generation-fenced checkpoint commits (``CheckpointManager.
  commit_guard``), keep a stale generation from training or journaling
  over the live run.
- **Re-initialise, don't restart (when possible).** At an epoch boundary
  a membership change tears the process group down in-process
  (:class:`ElasticRuntime`: ``init_process_group`` over
  ``tcp://<coordinator>`` for the new world, NCCL for a model on the card
  and gloo on the CPU; ``destroy_process_group`` on the way out), restores
  the last epoch checkpoint and re-shards the data by the new (rank,
  world). A collective that hangs mid-epoch (a dead peer, caught by a
  ``CollectiveWatchdog`` deadline) becomes a membership bump the same
  way: the wedged step is abandoned on its daemon thread, the old group
  is leaked (kept referenced, never destroyed: its teardown could wait on
  the dead peer) and training resumes from the epoch checkpoint. Only
  when teardown itself fails does the worker raise
  :class:`ElasticRestartRequired`, which ``checkpoint/supervisor.py``
  maps to ``ELASTIC_RESTART_EXIT`` and a fresh process.

Determinism: membership changes land only at epoch boundaries, every
epoch ends in a sharded checkpoint, and a restore replays the exact
parameters, updater state and generator state, so a same-world-size
restart is bitwise the uninterrupted run.

Clocks: lease freshness compares store-written wall timestamps against
the observer's clock (``clock=`` is injectable for the skew tests).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import socket
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.parallel.leases import LEASE_PREFIX, LeaseBoard  # noqa: F401

log = logging.getLogger(__name__)

GEN_PREFIX = "gen-"
BUMP_PREFIX = "bump-"

__all__ = [
    "ElasticError", "RendezvousTimeout",
    "ElasticRestartRequired", "StaleGenerationError", "Membership",
    "LeaseBoard", "Rendezvous", "ElasticRuntime", "ElasticWorker",
    "GenerationRecord", "ElasticRunSummary",
]


class ElasticError(RuntimeError):
    """Base class for elastic-layer failures."""


class RendezvousTimeout(ElasticError):
    """No membership formed within the join deadline (store outage, no
    leader, or every peer gone)."""


class StaleGenerationError(ElasticError):
    """A checkpoint commit was attempted by a generation the store says is
    superseded — the generation fence that keeps an evicted-but-alive
    leader from journaling over the live run."""


class ElasticRestartRequired(ElasticError):
    """In-process recovery is not possible (runtime teardown failed);
    the process should exit and be respawned by the supervisor
    (checkpoint/supervisor.py maps this to ``ELASTIC_RESTART_EXIT``)."""


class _MembershipChanged(ElasticError):
    """Internal epoch-boundary signal: re-rendezvous."""


# =========================================================== membership data
@dataclasses.dataclass
class Membership:
    """One generation's committed membership (immutable once adopted)."""
    generation: int
    members: List[str]            # sorted worker ids; members[0] leads
    coordinator: str              # "host:port" of the generation's store
    reason: str = ""
    writer: str = ""

    def rank_of(self, worker_id: str) -> int:
        return self.members.index(worker_id)

    @property
    def world_size(self) -> int:
        return len(self.members)

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Membership":
        d = json.loads(data.decode())
        return cls(generation=int(d["generation"]),
                   members=list(d["members"]),
                   coordinator=str(d["coordinator"]),
                   reason=d.get("reason", ""), writer=d.get("writer", ""))


def _gen_name(generation: int) -> str:
    return f"{GEN_PREFIX}{generation:06d}"


def _bump_name(generation: int) -> str:
    return f"{BUMP_PREFIX}{generation:06d}"


# =============================================================== rendezvous
def _pick_free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class Rendezvous:
    """The membership protocol over the store (see module docstring)."""

    def __init__(self, store, lease_board: LeaseBoard,
                 join_timeout_s: float = 60.0, poll_s: float = 0.2,
                 scaledown_grace_s: float = 0.0,
                 advertise_host: str = "localhost",
                 pick_port: Callable[[], int] = _pick_free_port,
                 sleep: Callable[[float], None] = time.sleep):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self.store = as_backend(store)
        self.leases = lease_board
        self.worker_id = lease_board.worker_id
        self.clock = lease_board.clock
        self.join_timeout_s = float(join_timeout_s)
        self.poll_s = float(poll_s)
        # how long a leader-elect holds a membership SMALLER than the
        # previous generation's before committing it: a whole-fleet
        # preemption respawns workers on a slow path (process start +
        # imports), and without the grace the first one back would form a
        # world of one and train ahead alone. Availability cost: each
        # genuine shrink commits this much later. Keep it under
        # join_timeout_s.
        self.scaledown_grace_s = float(scaledown_grace_s)
        self.advertise_host = advertise_host
        self.pick_port = pick_port
        self.sleep = sleep
        self.evictions = 0
        self.memberships_written = 0

    # -------------------------------------------------------------- records
    def current(self) -> Optional[Membership]:
        """Highest committed membership record, or None before gen 1."""
        from deeplearning4j_tpu_torch.checkpoint.storage import StorageNotFoundError
        names = self.store.list(prefix=GEN_PREFIX)
        for name in reversed(sorted(names)):
            try:
                return Membership.from_json(self.store.get(name))
            except StorageNotFoundError:
                continue  # raced a writer; try the next older record
            except Exception as e:
                log.warning("unreadable membership %s (%s: %s) — skipping",
                            name, type(e).__name__, e)
        return None

    def request_bump(self, generation: int, reason: str):
        """Ask for ``generation`` to be superseded (idempotent, best
        effort: the lease/expiry rules drive the actual bump; this is the
        fast path + the observability breadcrumb)."""
        name = _bump_name(generation)
        try:
            if not self.store.exists(name):
                self.store.put(name, json.dumps({
                    "generation": generation, "reason": reason,
                    "worker": self.worker_id,
                    "time": self.clock()}).encode())
        except Exception as e:
            log.warning("bump request for gen %d failed (%s: %s)",
                        generation, type(e).__name__, e)

    def bump_requested(self, generation: int) -> Optional[str]:
        from deeplearning4j_tpu_torch.checkpoint.storage import StorageError
        try:
            data = self.store.get(_bump_name(generation))
        except (StorageError, OSError):
            return None
        try:
            rec = json.loads(data.decode())
            return f"{rec.get('reason', 'bump')} (by {rec.get('worker')})"
        except ValueError:
            return "bump (unreadable record)"

    # ---------------------------------------------------------------- join
    def propose_or_await(self, want_gen: int,
                         expected: Optional[int] = None,
                         reason: str = "") -> Membership:
        """Join generation >= ``want_gen``; returns the adopted membership
        this worker belongs to. The leader (smallest live id at the
        barrier) writes the record once every live lease has either
        joined or expired; everyone — including a duelling would-be
        leader — adopts the record the store actually holds (read-back
        convergence). A worker excluded by the adopted record retries at
        the NEXT generation (eviction → rejoin, never split-brain).
        ``expected`` (first generation only) additionally waits for that
        many workers so a fast starter cannot form a world of one."""
        deadline = self.clock() + self.join_timeout_s
        want = int(want_gen)
        first_settle: Optional[float] = None
        self.leases.write(barrier=want)
        while True:
            cur = self.current()
            if cur is not None and cur.generation >= want:
                if self.worker_id in cur.members:
                    self.leases.write(barrier=cur.generation)
                    return cur
                # committed without us: our lease looked dead. Rejoin.
                self.evictions += 1
                log.warning("%s evicted from gen %d (%s) — rejoining at "
                            "gen %d", self.worker_id, cur.generation,
                            cur.reason, cur.generation + 1)
                want = cur.generation + 1
                self.leases.write(barrier=want)
            if self.clock() > deadline:
                raise RendezvousTimeout(
                    f"{self.worker_id}: no membership for gen >= "
                    f"{want_gen} within {self.join_timeout_s:.0f}s")
            try:
                self.leases.refresh_if_due()  # stay alive while waiting
            except Exception as e:
                log.warning("lease refresh during rendezvous failed "
                            "(%s: %s)", type(e).__name__, e)
            leases = self.leases.read_all()
            live = self.leases.live(leases)
            cands = sorted(w for w, r in live.items()
                           if int(r.get("barrier", 0)) >= want)
            settled = bool(cands) and all(
                int(r.get("barrier", 0)) >= want for r in live.values())
            if expected is not None and len(cands) < expected:
                settled = False
            if settled and cands[0] == self.worker_id:
                prev = cur  # highest committed record, read this loop
                if (self.scaledown_grace_s > 0 and prev is not None
                        and prev.generation < want
                        and len(cands) < len(prev.members)):
                    if first_settle is None:
                        first_settle = self.clock()
                    if self.clock() - first_settle < self.scaledown_grace_s:
                        self.sleep(self.poll_s)
                        continue  # a respawning member may yet come back
                port = self.pick_port()
                rec = Membership(
                    generation=want, members=cands,
                    coordinator=f"{self.advertise_host}:{port}",
                    reason=reason, writer=self.worker_id)
                try:
                    self.store.put(_gen_name(want), rec.to_json())
                    self.memberships_written += 1
                except Exception as e:
                    log.warning("membership write for gen %d failed "
                                "(%s: %s) — retrying", want,
                                type(e).__name__, e)
                # loop: adopt the read-back record (ours, or a duelling
                # writer's — last put wins and everyone converges on it)
                continue
            self.sleep(self.poll_s)

    # ------------------------------------------------------ change detection
    def membership_changed(self, m: Membership) -> Optional[str]:
        """Epoch-boundary probe: why (if at all) generation ``m`` must
        end. Returns a reason string or None."""
        cur = self.current()
        if cur is not None and cur.generation > m.generation:
            return f"superseded by gen {cur.generation} ({cur.reason})"
        bump = self.bump_requested(m.generation)
        if bump:
            return f"bump requested: {bump}"
        leases = self.leases.read_all()
        live = self.leases.live(leases)
        dead = [w for w in m.members if w not in live]
        if dead:
            return f"peer lease expired: {sorted(dead)}"
        joiners = [w for w in sorted(live) if w not in m.members]
        if joiners:
            return f"new worker(s) waiting: {joiners}"
        ahead = [w for w in m.members
                 if int(live.get(w, {}).get("barrier", 0)) > m.generation]
        if ahead:
            return f"peer(s) moved to a later generation: {sorted(ahead)}"
        return None


# ====================================================== collective runtime
class ElasticRuntime:
    """Join and leave ``torch.distributed`` with a changing world size.

    ``join`` runs ``init_process_group(backend, init_method="tcp://<coordinator>",
    world_size, rank, timeout)``; rank 0 (the generation's leader) hosts
    the store on the record's port. ``leave(graceful=True)`` (every member
    leaving together at a boundary) destroys the group under a deadline;
    ``leave(graceful=False)`` (a crash or a hang: a peer may be dead)
    aborts an NCCL communicator rather than waiting on it, and keeps the
    old group referenced in a graveyard so its teardown never runs (it
    could wait on the dead peer) until the process exits. World size 1
    skips ``torch.distributed`` entirely. The backend is NCCL on the card
    and gloo on the CPU unless given."""

    def __init__(self, init_timeout_s: float = 60.0, backend: Optional[str] = None):
        self.init_timeout_s = float(init_timeout_s)
        self.backend = backend
        self._graveyard: list = []   # deliberate leaks for the process's
        self._joined_multi = False   # lifetime (a handful a run)
        self.joins = 0

    def join(self, coordinator: str, num_processes: int, process_id: int):
        import torch
        import torch.distributed as dist
        if self._joined_multi:
            self.leave()
        if num_processes <= 1:
            return
        if dist.is_initialized():
            raise ElasticError(
                "torch.distributed is already initialised outside the elastic "
                "runtime; elastic training owns the process group's lifecycle and "
                "cannot take over an existing one")
        backend = self.backend or ("nccl" if torch.cuda.is_available() else "gloo")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=int(num_processes),
            rank=int(process_id), timeout=datetime.timedelta(seconds=self.init_timeout_s))
        self._joined_multi = True
        self.joins += 1
        if dist.get_world_size() != num_processes:
            raise ElasticError(f"the process group came up with {dist.get_world_size()} "
                               f"ranks, expected {num_processes}")

    def leave(self, graceful: bool = False):
        """Detach from the current process group (see the class docstring)."""
        if not self._joined_multi:
            return
        import torch.distributed as dist
        self._joined_multi = False
        if not dist.is_initialized():
            return
        pg = dist.group.WORLD
        if graceful:
            from deeplearning4j_tpu_torch.parallel.watchdog import CollectiveWatchdog
            try:
                CollectiveWatchdog(timeout_s=20.0).call(
                    dist.destroy_process_group, what="graceful process-group teardown")
                return
            except Exception as e:
                log.warning("graceful process-group teardown failed (%s: %s): leaking "
                            "it instead", type(e).__name__, e)
                if not dist.is_initialized():
                    self._graveyard.append(pg)
                    return
        self._graveyard.append(pg)
        if dist.get_backend() == "nccl":
            abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
            if abort is not None:
                try:
                    abort()
                    return
                except Exception as e:
                    log.warning("NCCL abort failed (%s: %s)", type(e).__name__, e)
        dist.destroy_process_group()


def _is_collective_runtime_error(e: BaseException) -> bool:
    """An ERRORED (not merely hung) collective: the backend's own error."""
    try:
        import torch.distributed as dist
        if isinstance(e, getattr(dist, "DistBackendError", ())):
            return True
    except ImportError:
        pass
    return type(e).__name__ in ("DistBackendError", "DistNetworkError")


# ============================================================ elastic worker
@dataclasses.dataclass
class GenerationRecord:
    """One generation as this worker experienced it."""
    generation: int
    world_size: int
    rank: int
    epochs: int = 0
    restored_from: Optional[str] = None   # journal entry file, if restored
    ended: str = ""                       # why the generation ended
    wall_s: float = 0.0


@dataclasses.dataclass
class ElasticRunSummary:
    """What happened across the whole elastic run on THIS worker."""
    worker_id: str
    completed: bool
    epochs: int
    generations: List[GenerationRecord]
    evictions: int
    model: object = None

    def __str__(self):
        gens = "; ".join(
            f"g{g.generation}[{g.rank}/{g.world_size}]x{g.epochs}ep"
            + (f" ({g.ended})" if g.ended else "")
            for g in self.generations)
        return (f"elastic[{self.worker_id}]: completed={self.completed} "
                f"epochs={self.epochs} evictions={self.evictions} [{gens}]")


class ElasticWorker:
    """One worker of an elastic training job (run one per process).

    Usage (per worker process)::

        cm = CheckpointManager(storage=backend, sharded=True,
                               async_write=False)
        worker = ElasticWorker(store=backend, worker_id="w0",
                               checkpoint_manager=cm, num_workers=4)
        summary = worker.run(model_factory, data, num_epochs=10)

    ``store`` is the rendezvous medium (any StorageBackend or a
    directory); it may be the checkpoint store itself or a sibling.
    ``num_workers`` is the expected INITIAL quorum — later generations
    form from whoever holds a fresh lease. ``data`` is a re-iterable of
    global DataSet batches (each worker takes its row shard per its rank
    in the current generation — the membership-change re-sharding) or a
    callable ``(rank, world_size) -> iterable`` for custom sharding.
    ``on_generation(model, membership, rank, world)`` runs after every
    (re)build — chaos tests attach fault injectors there; production code
    re-attaches listeners a restored model does not carry.
    """

    def __init__(self, store, worker_id: str, checkpoint_manager,
                 num_workers: Optional[int] = None,
                 lease_ttl_s: float = 10.0,
                 heartbeat_s: Optional[float] = None,
                 join_timeout_s: float = 120.0,
                 poll_s: float = 0.2,
                 scaledown_grace_s: float = 0.0,
                 collective_timeout_s: Optional[float] = 60.0,
                 init_timeout_s: float = 60.0,
                 max_generations: int = 50,
                 max_consecutive_failures: int = 3,
                 advertise_host: str = "localhost",
                 clock: Callable[[], float] = time.time,
                 on_generation: Optional[Callable] = None,
                 backend: Optional[str] = None):
        from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
        self.store = as_backend(store)
        self.worker_id = str(worker_id)
        self.cm = checkpoint_manager
        self.num_workers = num_workers
        self.collective_timeout_s = collective_timeout_s
        self.max_generations = int(max_generations)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.on_generation = on_generation
        self.leases = LeaseBoard(self.store, worker_id, ttl_s=lease_ttl_s,
                                 heartbeat_s=heartbeat_s, clock=clock)
        self.rendezvous = Rendezvous(self.store, self.leases,
                                     join_timeout_s=join_timeout_s,
                                     poll_s=poll_s,
                                     scaledown_grace_s=scaledown_grace_s,
                                     advertise_host=advertise_host)
        if backend is None and getattr(checkpoint_manager, "device", None) is not None:
            import torch
            if torch.device(checkpoint_manager.device).type == "cpu":
                backend = "gloo"
        self.runtime = ElasticRuntime(init_timeout_s=init_timeout_s, backend=backend)
        # obs: generation id / world size are THE labels every elastic
        # post-mortem starts from; the transition pause (generation end →
        # training again: re-rendezvous + runtime re-init + restore) is
        # the availability cost of a membership change
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        self._m_generation = reg.gauge(
            "elastic_generation", unit="generation",
            help="membership generation this worker is training in")
        self._m_world_size = reg.gauge(
            "elastic_world_size", unit="workers",
            help="world size of the current membership generation")
        self._m_generations = reg.counter(
            "elastic_generations_total", unit="generations",
            help="membership generations this worker joined")
        self._m_transition_pause = reg.histogram(
            "elastic_transition_pause_ms", unit="ms",
            help="membership-transition pause: generation end to training "
                 "again (rendezvous + runtime re-init + restore)")
        self._m_evictions = reg.gauge(
            "elastic_evictions", unit="evictions",
            help="times this worker was evicted and had to rejoin")

    # ------------------------------------------------------------ internals
    def _obs_event(self, name: str, **attrs):
        """Lifecycle breadcrumb into the telemetry pipeline: through the
        tracer when tracing is on (reaches every sink, flight ring
        included), straight into the flight ring otherwise — generation
        boundaries must be in the crash ring even with tracing off."""
        from deeplearning4j_tpu_torch.obs.flight import get_flight_recorder
        from deeplearning4j_tpu_torch.obs.trace import get_tracer
        tracer = get_tracer()
        if tracer.enabled:
            tracer.event(name, **attrs)
            return
        fr = get_flight_recorder()
        if fr is not None:
            fr.event(name, **attrs)

    def _assert_current(self, m: Membership):
        """Checkpoint commit fence: refuse to journal from a superseded
        generation (the split-brain guard for an evicted-but-alive
        leader). TOCTOU-approximate like any lease fence — the window is
        one store read at epoch cadence."""
        cur = self.rendezvous.current()
        if cur is not None and cur.generation != m.generation:
            raise StaleGenerationError(
                f"{self.worker_id} (gen {m.generation}) refusing to "
                f"journal a checkpoint: store is at gen {cur.generation}")

    def _boundary_vote(self, local_change: Optional[str],
                       world: int) -> Optional[str]:
        """Epoch-boundary membership decision, made COLLECTIVELY: each
        member contributes its local store observation and everyone
        adopts "change" if anyone saw one — so the whole generation exits
        at the SAME boundary and the graceful teardown can complete. (One
        tiny all-reduce an epoch; a dead peer makes it hang, which the
        watchdog deadline turns into the usual escalation.)"""
        if world <= 1:
            return local_change
        import torch
        import torch.distributed as dist
        from deeplearning4j_tpu_torch.parallel.watchdog import CollectiveWatchdog

        def vote():
            dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
            flags = torch.tensor([1 if local_change else 0], dtype=torch.int32,
                                 device=dev)
            dist.all_reduce(flags)
            return int(flags.item())
        n = CollectiveWatchdog(
            timeout_s=self.collective_timeout_s or 60.0).call(
                vote, what="membership boundary vote")
        if local_change is not None:
            return local_change
        return "peer detected a membership change" if n > 0 else None

    def _data_for(self, data, rank: int, world: int,
                  membership: Optional[Membership] = None):
        if hasattr(data, "reader") and hasattr(data, "epoch_order"):
            # a datasets/sharded.py ShardedDataset: every generation gets
            # a fresh reader for its (rank, world) slice, claiming
            # record-range leases under THIS worker's id and the current
            # membership generation (the data-plane half of the
            # split-brain fence — a stale generation's reader raises
            # StaleDataLeaseError instead of consuming ranges the live
            # fleet owns)
            return data.reader(
                rank, world, worker_id=self.worker_id,
                generation=membership.generation if membership else 0)
        if callable(data):
            return data(rank, world)
        if world <= 1:
            return data
        from deeplearning4j_tpu_torch.parallel.sharding import shard_iterator
        return shard_iterator(data, rank, world)

    def _build_model(self, model_factory, rec: GenerationRecord):
        restored = self.cm.restore_latest()
        if restored is not None:
            rec.restored_from = (restored._restored_from.path
                                 if restored._restored_from else None)
            return restored
        return model_factory()

    # ----------------------------------------------------------------- run
    def run(self, model_factory: Callable, data, num_epochs: int,
            ) -> ElasticRunSummary:
        """Train to ``num_epochs`` total epochs across however many
        membership generations it takes; returns when this worker has
        seen the final epoch complete. Raises ``RendezvousTimeout`` /
        ``ElasticError`` when no quorum forms, ``ElasticRestartRequired``
        when only a process respawn can recover."""
        from deeplearning4j_tpu_torch.parallel.trainer import ClusterTrainer
        from deeplearning4j_tpu_torch.parallel.watchdog import (
            CollectiveTimeoutError)
        gens: List[GenerationRecord] = []
        self.leases.start()
        model = None
        consecutive = 0
        try:
            cur = self.rendezvous.current()
            want = 1 if cur is None else cur.generation + 1
            first = cur is None
            while True:
                if len(gens) >= self.max_generations:
                    raise ElasticError(
                        f"exceeded max_generations={self.max_generations} "
                        "— the membership is churning faster than "
                        "training progresses")
                t_rdv = time.monotonic()
                m = self.rendezvous.propose_or_await(
                    want, expected=(self.num_workers if first else None),
                    reason="initial quorum" if first else "membership change")
                first = False
                rank, world = m.rank_of(self.worker_id), m.world_size
                rec = GenerationRecord(generation=m.generation,
                                       world_size=world, rank=rank)
                gens.append(rec)
                self._m_generation.set(m.generation)
                self._m_world_size.set(world)
                self._m_generations.inc()
                self._m_evictions.set(self.rendezvous.evictions)
                self._obs_event("elastic.generation_start",
                                generation=m.generation, world=world,
                                rank=rank, reason=m.reason)
                clean_boundary = False
                t0 = time.monotonic()
                try:
                    self.runtime.join(m.coordinator, world, rank)
                except Exception as e:
                    # ANY join failure retries at the next generation;
                    # the common one is init_process_group timing out
                    # after the gen's leader died between writing the
                    # record and hosting its store
                    rec.ended = f"join failed: {type(e).__name__}: {e}"
                    log.warning("%s gen %d join failed (%s: %s)",
                                self.worker_id, m.generation,
                                type(e).__name__, e)
                    self.rendezvous.request_bump(
                        m.generation,
                        f"join failed on {self.worker_id}: "
                        f"{type(e).__name__}")
                    self.runtime.leave()  # drop any half-built state
                    consecutive += 1
                    if consecutive >= self.max_consecutive_failures:
                        raise ElasticError(
                            f"{self.worker_id}: {consecutive} consecutive "
                            f"join failures (last: {type(e).__name__}: "
                            f"{e})") from e
                    want = m.generation + 1
                    continue
                local = None
                try:
                    # re-read the journal from storage: in-process
                    # survivors only APPEND entries locally on the host
                    # that journals (the leader) — without the refresh a
                    # non-leader would restore an older checkpoint than
                    # its peers and the generation's collectives would
                    # diverge. Also re-agrees the save sequence counter
                    # fleet-wide after failed/partial save attempts.
                    self.cm.refresh()
                    model = self._build_model(model_factory, rec)
                    self.cm.fence(model)
                    self.cm.commit_guard = lambda m=m: self._assert_current(m)
                    if not self.cm.checkpoints():
                        # epoch-0 set: even a crash in epoch 1 restores
                        # pristine state instead of refitting a maybe-
                        # different fresh model
                        self.cm.save(model)
                    trainer = ClusterTrainer(model)
                    local = self._data_for(data, rank, world, m)
                    if self.on_generation is not None:
                        self.on_generation(model, m, rank, world)
                    if m.generation > 1:
                        # generation 1 is the initial quorum, not a
                        # transition; everything later — in-process
                        # re-shard OR a respawned worker rejoining — pays
                        # this pause before training resumes
                        pause_ms = (time.monotonic() - t_rdv) * 1000.0
                        self._m_transition_pause.observe(pause_ms)
                        self._obs_event("elastic.transition_pause",
                                        generation=m.generation,
                                        world=world,
                                        pause_ms=round(pause_ms, 2))
                    while model.epoch < num_epochs:
                        # exactly ONE epoch per fit call: num_epochs is
                        # the run TOTAL when a restored model carries a
                        # resume marker (first call after restore) and a
                        # relative count otherwise
                        target = (model.epoch + 1
                                  if getattr(model, "_resume_state", None)
                                  is not None else 1)
                        trainer.fit_local_shard(
                            local, num_epochs=target,
                            collective_timeout_s=self.collective_timeout_s,
                            watchdog_every=1,
                            # step-cadence triggers (save_every_n_steps on
                            # the manager) commit MID-epoch sharded
                            # checkpoints — with a seekable sharded reader
                            # a kill-and-resume then replays ZERO consumed
                            # batches even across an N→M reshard
                            checkpoint_manager=self.cm)
                        consecutive = 0
                        self.cm.save(model)
                        rec.epochs += 1
                        if model.epoch >= num_epochs:
                            break  # done: no boundary vote after the end
                        change = self._boundary_vote(
                            self.rendezvous.membership_changed(m), world)
                        if change is not None:
                            raise _MembershipChanged(change)
                    rec.ended = "completed"
                    rec.wall_s = time.monotonic() - t0
                    self._leave_guarded(graceful=True)
                    total = sum(g.epochs for g in gens)
                    summary = ElasticRunSummary(
                        worker_id=self.worker_id, completed=True,
                        epochs=total, generations=gens,
                        evictions=self.rendezvous.evictions, model=model)
                    log.info("%s", summary)
                    return summary
                except _MembershipChanged as e:
                    rec.ended = str(e)
                    clean_boundary = True  # whole generation left together
                    log.info("%s gen %d ends at epoch boundary: %s",
                             self.worker_id, m.generation, e)
                    self.rendezvous.request_bump(m.generation, str(e))
                except CollectiveTimeoutError as e:
                    # THE escalation: a hung mid-epoch collective (dead
                    # peer) becomes a membership bump, not a dead job. The
                    # wedged dispatch thread is already abandoned
                    # (daemon); training resumes from the epoch checkpoint
                    rec.ended = f"collective timeout -> membership bump"
                    log.warning("%s gen %d: hung collective (%s) — "
                                "escalating to membership bump",
                                self.worker_id, m.generation, e)
                    self.rendezvous.request_bump(
                        m.generation, f"collective timeout on "
                        f"{self.worker_id}")
                    consecutive += 1
                except StaleGenerationError as e:
                    rec.ended = f"fenced: {e}"
                    log.warning("%s: %s — rejoining", self.worker_id, e)
                except Exception as e:
                    rec.ended = f"{type(e).__name__}: {e}"
                    self.rendezvous.request_bump(
                        m.generation, f"{type(e).__name__} on "
                        f"{self.worker_id}")
                    if world > 1 and _is_collective_runtime_error(e):
                        # an ERRORED (not merely hung) collective can
                        # poison the process (a transport thread may
                        # abort it later whatever Python does). In-process recovery is off the table;
                        # exit and let the supervisor respawn us into the
                        # next generation (the SIGKILL-proof path).
                        rec.ended = (f"collective runtime error -> "
                                     f"process restart ({e})")
                        log.warning("%s gen %d: collective runtime error "
                                    "(%s) — escalating to process restart",
                                    self.worker_id, m.generation, e)
                        raise ElasticRestartRequired(
                            f"collective runtime error on "
                            f"{self.worker_id}: {e}") from e
                    log.warning("%s gen %d failed (%s: %s) — requesting "
                                "membership bump", self.worker_id,
                                m.generation, type(e).__name__, e)
                    consecutive += 1
                    if consecutive >= self.max_consecutive_failures:
                        raise
                finally:
                    rec.wall_s = time.monotonic() - t0
                    if local is not None and hasattr(local, "release_all"):
                        # drop this generation's record-range leases so
                        # the next generation's readers don't wait a TTL
                        # on ranges we will never consume
                        try:
                            local.release_all()
                        except Exception as le:
                            log.warning("data-lease release failed "
                                        "(%s: %s)", type(le).__name__, le)
                    self._obs_event("elastic.generation_end",
                                    generation=m.generation,
                                    epochs=rec.epochs, reason=rec.ended)
                # a synchronized boundary exit tears down cooperatively
                # (the group destroyed); crash/hang exits leak it instead
                self._leave_guarded(graceful=clean_boundary)
                cur = self.rendezvous.current()
                want = max(m.generation,
                           cur.generation if cur else 0) + 1
        except ElasticRestartRequired as e:
            # the process is about to exit ELASTIC_RESTART_EXIT — this is
            # the flight recorder's moment: the ring holds the victim's
            # last seconds and nothing after this write survives
            from deeplearning4j_tpu_torch.obs.flight import flush_flight_recorder
            flush_flight_recorder(f"ELASTIC_RESTART_EXIT: {e}")
            raise
        finally:
            self.cm.commit_guard = None
            self.cm.fence(None)
            self.leases.stop()
            self.leases.withdraw()

    def _leave_guarded(self, graceful: bool = False):
        """Teardown bounded by a deadline; a teardown that itself wedges
        means in-process recovery is off the table — escalate to a
        process restart."""
        from deeplearning4j_tpu_torch.parallel.watchdog import (
            CollectiveTimeoutError, CollectiveWatchdog)
        try:
            CollectiveWatchdog(timeout_s=45.0).call(
                lambda: self.runtime.leave(graceful=graceful),
                what="elastic runtime teardown")
        except CollectiveTimeoutError as e:
            raise ElasticRestartRequired(
                f"collective runtime teardown wedged on {self.worker_id}; "
                "process must be respawned") from e
