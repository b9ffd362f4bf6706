"""Chaos harness for the fault-tolerance stack.

Three kinds of injected failure, all deterministic (seeded) so chaos tests
replay exactly:

- **Process death** — :class:`FaultInjector`, a training listener that
  raises :class:`SimulatedCrash` where a preemption lands from the
  training loop's point of view: after a step's parameter update and
  before the next batch (``kill_at_step``), at an epoch boundary before
  the boundary checkpoint (``kill_at_epoch``), or at a random step drawn
  from a seeded RNG (``kill_probability``). Tests drive it to prove the
  subsystem's core claim: crash at an ARBITRARY point + ``train_until``'s
  restore/refit loop produces final params bitwise-identical to the
  uninterrupted run.

- **Storage faults** — :class:`FlakyBackend`, a
  checkpoint/storage.py wrapper injecting seeded transient errors,
  scripted error bursts, scripted permanent errors and write latency into
  any backend. Put under a ``RetryingBackend`` it proves transient faults
  never kill a run; put bare it proves they surface as loud
  ``CheckpointError``s instead of corrupt state.

- **Data corruption** — ``tear_file`` / ``flip_byte`` (local paths) and
  ``tear_object`` / ``flip_object_byte`` (any backend) simulate the
  disk-level failure modes the manifest layer must detect: a write torn
  by a crash (truncation) and silent bit rot (flip) — both must make
  ``restore_latest`` fall back, never restore garbage, identically
  through every backend.

Counterpart of ``deeplearning4j_tpu/checkpoint/faults.py``, the same
schedules for the same seeds.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import List, Optional

from deeplearning4j_tpu_torch.checkpoint.storage import (
    StorageBackend, TransientStorageError)

log = logging.getLogger(__name__)


class SimulatedCrash(RuntimeError):
    """Raised by FaultInjector to simulate a preemption/crash mid-training."""


class FaultInjector:
    """Listener that raises :class:`SimulatedCrash` at a chosen point.
    Attach with ``model.set_listeners`` (or alongside real listeners via
    ``add_listener``)::

        net.set_listeners(FaultInjector(kill_at_step=7))
        with pytest.raises(SimulatedCrash):
            net.fit(data, num_epochs=3, checkpoint_manager=cm)

    Modes (at least one; they compose — first to trigger fires):

    - ``kill_at_step=k``: crash once ``k`` optimizer steps have fully
      applied their updates (before step ``k``'s checkpoint trigger, so
      the newest durable checkpoint is an EARLIER step);
    - ``kill_at_epoch=e``: crash at the boundary where the ``e``-th epoch
      (1-based) has just completed — after its last step's checkpoint,
      BEFORE the epoch counter increments or an epoch-boundary save runs,
      the exact window a preemption likes to find;
    - ``kill_probability=p``: after every step, crash with probability
      ``p`` from a seeded RNG — randomized preemption points that replay
      identically for a given ``seed``.

    ``max_kills`` bounds the total crashes one injector fires (default 1:
    a listener that keeps killing a resumed run would turn ``train_until``
    into a restart-budget test); raise it to simulate repeated preemption.

    ``kill_mode`` selects HOW the injector kills:

    - ``"exception"`` (default): raise :class:`SimulatedCrash` — the
      in-process crash ``train_until``'s restore/refit loop recovers;
    - ``"process"``: ``SIGKILL`` the current process — REAL process death
      (no cleanup, no atexit, no flushing), the preemption shape a process
      supervisor must survive. Only meaningful in a worker subprocess.
    """

    def __init__(self, kill_at_step: Optional[int] = None,
                 kill_at_epoch: Optional[int] = None,
                 kill_probability: Optional[float] = None,
                 seed: int = 0, max_kills: int = 1,
                 kill_mode: str = "exception"):
        if kill_at_step is None and kill_at_epoch is None \
                and kill_probability is None:
            raise ValueError("need kill_at_step, kill_at_epoch or "
                             "kill_probability")
        if kill_at_step is not None and kill_at_step < 1:
            raise ValueError("kill_at_step must be >= 1")
        if kill_at_epoch is not None and kill_at_epoch < 1:
            raise ValueError("kill_at_epoch must be >= 1")
        if kill_probability is not None \
                and not 0.0 < kill_probability <= 1.0:
            raise ValueError("kill_probability must be in (0, 1]")
        if kill_mode not in ("exception", "process"):
            raise ValueError("kill_mode must be 'exception' or 'process'")
        self.kill_mode = kill_mode
        self.kill_at_step = None if kill_at_step is None else int(kill_at_step)
        self.kill_at_epoch = (None if kill_at_epoch is None
                              else int(kill_at_epoch))
        self.kill_probability = kill_probability
        self.max_kills = int(max_kills)
        self._rng = random.Random(seed)
        self.fired = False
        self.kills = 0

    def _kill(self, why: str):
        self.fired = True
        self.kills += 1
        # flush the crash flight recorder BEFORE dying — for
        # kill_mode="process" the SIGKILL leaves no other chance, and the
        # dump in storage is what the supervisor's post-mortem reads
        try:
            from deeplearning4j_tpu_torch.obs.flight import flush_flight_recorder
            flush_flight_recorder(f"fault injection: {why}")
        except Exception:
            log.exception("flight-recorder flush before injected kill "
                          "failed")
        if self.kill_mode == "process":
            # REAL death: no exception anyone could catch, no cleanup —
            # exactly what a preemption does to a worker
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(f"fault injection: {why}")

    def _armed(self) -> bool:
        return self.kills < self.max_kills

    def iteration_done(self, model, iteration, epoch):
        if not self._armed():
            return
        # ``iteration`` is the model's pre-increment counter: after the k-th
        # optimizer step it reads k-1, so the crash lands exactly when
        # kill_at_step steps have fully applied their updates
        if self.kill_at_step is not None \
                and iteration + 1 >= self.kill_at_step:
            self._kill(f"killed training after step {iteration + 1}")
        if self.kill_probability is not None \
                and self._rng.random() < self.kill_probability:
            self._kill(f"randomly killed training after step "
                       f"{iteration + 1} (p={self.kill_probability})")

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        # fires with model.epoch still at the just-completed epoch's index
        # (fit increments afterwards), so completing epoch index e means
        # e+1 epochs are done
        if self._armed() and self.kill_at_epoch is not None \
                and model.epoch + 1 >= self.kill_at_epoch:
            self._kill(f"killed training at the end of epoch "
                       f"{model.epoch + 1}")


class FlakyBackend(StorageBackend):
    """Storage-fault injection wrapper (chaos testing's storage half).

    Deterministic (seeded) TRANSIENT faults: each intercepted op fails
    with :class:`TransientStorageError` with probability
    ``transient_rate`` — drawn from ``random.Random(seed)``, so a given
    seed yields the same fault schedule every run. On top of that:

    - ``script_failures(n, error=...)`` queues ``n`` guaranteed failures
      for the next matching ops (deterministic "store is down for exactly
      two puts" scenarios, or a scripted *permanent* error);
    - ``put_latency_s`` sleeps before every put — the slow-object-store
      write the per-op timeout in ``RetryingBackend`` must bound.

    ``ops`` restricts which operations can fault (default: all mutating +
    reading ops). ``match`` restricts faults to object NAMES with that
    prefix (for ``list``, the listing prefix) — how chaos is aimed at the
    elastic membership path specifically: ``match="lease-"`` faults only
    the lease heartbeats, ``match="gen-"`` only the membership records,
    while checkpoints riding the same backend stay healthy. Counters
    (``calls``, ``faults_injected``) let tests assert the chaos actually
    happened — a chaos test whose injector never fired proves nothing.
    """

    _ALL_OPS = ("put", "get", "list", "delete", "exists")

    def __init__(self, inner: StorageBackend, seed: int = 0,
                 transient_rate: float = 0.0, put_latency_s: float = 0.0,
                 ops=("put", "get", "list", "delete"),
                 match: Optional[str] = None):
        if not 0.0 <= transient_rate < 1.0:
            raise ValueError("transient_rate must be in [0, 1)")
        unknown = set(ops) - set(FlakyBackend._ALL_OPS)
        if unknown:
            raise ValueError(f"unknown ops: {sorted(unknown)}")
        self.inner = inner
        self.transient_rate = float(transient_rate)
        self.put_latency_s = float(put_latency_s)
        self.ops = tuple(ops)
        self.match = match
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._scripted: List[BaseException] = []
        self.calls = 0
        self.faults_injected = 0

    def script_failures(self, n: int, error: Optional[BaseException] = None):
        """Queue ``n`` guaranteed failures for the next matching ops.
        ``error`` defaults to a TransientStorageError; pass a
        PermanentStorageError instance to script a non-retryable fault."""
        with self._lock:
            for _ in range(n):
                self._scripted.append(
                    error if error is not None else TransientStorageError(
                        "scripted transient storage fault"))

    def _maybe_fail(self, op: str, name: Optional[str] = None):
        if op not in self.ops:
            return
        if self.match is not None and \
                (name is None or not name.startswith(self.match)):
            return
        with self._lock:
            self.calls += 1
            if self._scripted:
                self.faults_injected += 1
                raise self._scripted.pop(0)
            if self.transient_rate and \
                    self._rng.random() < self.transient_rate:
                self.faults_injected += 1
                raise TransientStorageError(
                    f"injected transient fault on '{op}' "
                    f"(rate={self.transient_rate})")

    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        self._maybe_fail("put", name)
        if self.put_latency_s:
            time.sleep(self.put_latency_s)
        return self.inner.put(name, data, fsync_directory=fsync_directory)

    def get(self, name: str) -> bytes:
        self._maybe_fail("get", name)
        return self.inner.get(name)

    def list(self, prefix: str = "") -> List[str]:
        self._maybe_fail("list", prefix)
        return self.inner.list(prefix)

    def delete(self, name: str):
        self._maybe_fail("delete", name)
        return self.inner.delete(name)

    def exists(self, name: str) -> bool:
        self._maybe_fail("exists", name)
        return self.inner.exists(name)

    def clean_orphans(self):
        return self.inner.clean_orphans()

    def describe(self) -> str:
        return f"FlakyBackend({self.inner.describe()})"


# --------------------------------------------------------- data corruption
def tear_file(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate ``path`` to ``keep_fraction`` of its bytes — a torn write.
    Returns the new size."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_fraction))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def flip_byte(path: str, offset: int = -1):
    """XOR one byte (default: the last) — silent corruption that leaves the
    file size intact, so only a checksum can catch it."""
    size = os.path.getsize(path)
    pos = offset % size
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def tear_object(backend: StorageBackend, name: str,
                keep_fraction: float = 0.5) -> int:
    """Backend-generic ``tear_file``: replace the object with a truncated
    prefix of itself. (An object-store put is atomic, so a REAL torn write
    cannot happen there — but replication glitches and buggy middleboxes
    produce exactly this shape, and the sha256 fallback must catch it the
    same way.) Returns the new size."""
    data = backend.get(name)
    keep = max(0, int(len(data) * keep_fraction))
    backend.put(name, data[:keep])
    return keep


def flip_object_byte(backend: StorageBackend, name: str, offset: int = -1):
    """Backend-generic ``flip_byte``: XOR one byte of the object in place
    (size unchanged — only a checksum can catch it)."""
    data = bytearray(backend.get(name))
    pos = offset % len(data)
    data[pos] ^= 0xFF
    backend.put(name, bytes(data))
