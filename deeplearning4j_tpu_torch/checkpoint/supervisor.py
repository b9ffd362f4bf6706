"""Process-level preemption recovery: ``train_until_process``
(counterpart of ``deeplearning4j_tpu/checkpoint/supervisor.py``).

``train_until`` (checkpoint/resume.py) restarts a crashed fit WITHIN the
same process — which cannot help when the crash corrupts in-process state
(a wedged CUDA context, a poisoned allocator, a SIGKILL). This module is
the scheduler-shaped half: a supervisor that runs each fit attempt as a
fresh OS process and
respawns on failure, so recovery survives anything short of losing the
checkpoint store. ``RestartPolicy`` / ``CrashRecord`` / ``RunSummary``
semantics carry over from ``train_until`` — the budget, jittered backoff
and crash history read identically; only the unit of restart changed from
"fit attempt" to "worker process".

Exit-code protocol (what a worker process tells the supervisor):

- ``0``              — this worker's training target is complete;
- ``ELASTIC_RESTART_EXIT`` (17) — in-process elastic recovery failed:
  respawn me, I will rejoin the next
  membership generation;
- killed by a signal — preemption: respawned only with
  ``respawn_preempted=True`` (an elastic fleet keeps training WITHOUT the
  preempted worker; a fixed-world job wants it back);
- any other code   — a crash: respawn under the restart budget.

A worker that neither exits nor progresses is bounded by
``attempt_timeout_s`` (killed and treated as a crash) and the whole run
by ``overall_timeout_s`` — a supervised fleet can never hang its caller,
which is also what lets the chaos tests carry hard suite timeouts.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import signal
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from deeplearning4j_tpu_torch.checkpoint.resume import (
    CrashRecord, RestartBudgetExceeded, RestartPolicy, RunSummary)
from deeplearning4j_tpu_torch.utils.backoff import backoff_delay

log = logging.getLogger(__name__)

#: exit code a worker uses to say "respawn me" (the JAX package's
#: parallel/elastic.py raises ElasticRestartRequired; its worker script maps
#: it to this code)
ELASTIC_RESTART_EXIT = 17

__all__ = ["train_until_process", "ProcessRunSummary", "ProcessCrashRecord",
           "ELASTIC_RESTART_EXIT"]


@dataclasses.dataclass
class ProcessCrashRecord(CrashRecord):
    """A ``CrashRecord`` that also names the worker process it belongs
    to (``train_until``'s records carry over 1:1 otherwise)."""
    worker: int = 0


@dataclasses.dataclass
class ProcessRunSummary(RunSummary):
    """``RunSummary`` plus per-worker outcomes and log paths. ``model``
    is always None at the process level — the result of a supervised run
    lives in the checkpoint store, not in the supervisor's memory."""
    worker_status: Dict[int, str] = dataclasses.field(default_factory=dict)
    logs: Dict[int, List[str]] = dataclasses.field(default_factory=dict)


class _Worker:
    """Supervisor-side state for one worker slot."""

    def __init__(self, index: int):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.log_path: Optional[str] = None
        self.logs: List[str] = []
        self.started_at = 0.0
        self.attempt = 0           # spawn count for THIS slot
        self.status = "pending"    # running | completed | down | pending
        self.respawn_at: Optional[float] = None  # backoff gate


def train_until_process(worker_argv: Union[Sequence[str], Callable],
                        num_workers: int = 1,
                        restart_policy: Optional[RestartPolicy] = None,
                        checkpoint_manager=None,
                        respawn_preempted: bool = False,
                        attempt_timeout_s: Optional[float] = None,
                        overall_timeout_s: Optional[float] = None,
                        poll_s: float = 0.1,
                        env: Optional[dict] = None,
                        cwd: Optional[str] = None,
                        log_dir: Optional[str] = None,
                        on_restart: Optional[Callable] = None
                        ) -> ProcessRunSummary:
    """Run ``num_workers`` worker processes to completion, respawning per
    the exit-code protocol above under ``restart_policy``'s budget.

    ``worker_argv`` is the argv list every worker runs, or a callable
    ``(worker_index, attempt) -> argv`` (attempt is 1-based per slot).
    Workers learn their identity from their argv — the supervisor passes
    nothing implicitly.

    ``checkpoint_manager`` (optional, read-only here) annotates the crash
    history with the store's latest committed step at each crash/respawn
    (``refresh()`` + ``latest_step()``) — the operator sees how much
    progress each crash cost, exactly like ``train_until``'s records.

    ``on_restart(worker_index, attempt)`` fires before each respawn.

    Returns a :class:`ProcessRunSummary` once every worker has either
    completed or gone permanently down, with at least one completion.
    Raises :class:`RestartBudgetExceeded` (carrying the summary) when the
    restart budget runs out, when every worker is down with none
    complete, or when ``overall_timeout_s`` expires (everything is killed
    first — the caller never inherits a zombie fleet).
    """
    policy = restart_policy if restart_policy is not None else RestartPolicy()
    rng = random.Random(policy.seed)
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="train_until_process_")
    os.makedirs(log_dir, exist_ok=True)
    workers = [_Worker(i) for i in range(num_workers)]
    crashes: List[ProcessCrashRecord] = []
    restarts = 0
    t0 = time.monotonic()
    t0_wall = time.time()

    def argv_for(w: _Worker) -> List[str]:
        if callable(worker_argv):
            return list(worker_argv(w.index, w.attempt))
        return list(worker_argv)

    def store_step() -> Optional[int]:
        if checkpoint_manager is None:
            return None
        try:
            checkpoint_manager.refresh()
            return checkpoint_manager.latest_step()
        except Exception as e:
            log.warning("could not read store progress (%s: %s)",
                        type(e).__name__, e)
            return None

    def spawn(w: _Worker):
        w.attempt += 1
        w.log_path = os.path.join(log_dir,
                                  f"worker{w.index}-a{w.attempt}.log")
        w.logs.append(w.log_path)
        out = open(w.log_path, "wb")  # the file object is handed to the
        try:                          # child; closing ours is safe
            w.proc = subprocess.Popen(argv_for(w), stdout=out,
                                      stderr=subprocess.STDOUT,
                                      env=env, cwd=cwd)
        finally:
            out.close()
        w.started_at = time.monotonic()
        w.status = "running"
        w.respawn_at = None
        log.info("worker %d attempt %d spawned (pid %d)", w.index,
                 w.attempt, w.proc.pid)

    def kill_all():
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.kill()
                    w.proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired) as e:
                    log.warning("could not kill worker %d (%s: %s)",
                                w.index, type(e).__name__, e)

    def summary(completed: bool) -> ProcessRunSummary:
        return ProcessRunSummary(
            model=None, completed=completed, restarts=restarts,
            crashes=list(crashes), wall_time_s=time.monotonic() - t0,
            worker_status={w.index: w.status for w in workers},
            logs={w.index: list(w.logs) for w in workers})

    def give_up(message: str):
        kill_all()
        s = summary(False)
        log.error("train_until_process giving up: %s — %s", message, s)
        raise RestartBudgetExceeded(message, s)

    attached_dumps: set = set()

    def flight_tail() -> Optional[List[str]]:
        """The victim's last seconds, read back ACROSS the process
        boundary: the worker's crash flight recorder (obs/flight.py)
        flushed its ring into the checkpoint store before dying. Dumps
        predating this run are ignored, and each dump is attached to at
        most ONE crash record, oldest-unattached first — crashes are
        recorded in observation order, so two workers dying in the same
        monitor window each get their own victim's dump instead of both
        showing the newest one (best-effort: the supervisor cannot map
        its slot index to the worker's self-chosen recorder id).
        Watchdog-timeout dumps sort LAST: the elastic membership-bump
        escalation can flush one from a worker that then keeps running,
        so a dump flushed by an actual death always wins and a watchdog
        dump is attached only when nothing else is fresh (the non-elastic
        path, where the timeout did kill the attempt)."""
        if checkpoint_manager is None:
            return None
        store = getattr(checkpoint_manager, "_storage", None)
        if store is None:
            return None
        try:
            from deeplearning4j_tpu_torch.obs.flight import (dump_tail_summary,
                                                       read_dumps)
            fresh = [d for d in read_dumps(store)
                     if d.get("time", 0.0) >= t0_wall
                     and (d.get("worker_id"), d.get("time"))
                     not in attached_dumps]
            if fresh:
                fresh.sort(key=lambda d: (
                    str(d.get("reason", "")).startswith("watchdog timeout"),
                    d.get("time", 0.0)))
                dump = fresh[0]  # oldest unattached non-diagnostic first
                attached_dumps.add((dump.get("worker_id"),
                                    dump.get("time")))
                return dump_tail_summary(dump)
        except Exception as e:
            log.warning("could not read flight dump (%s: %s)",
                        type(e).__name__, e)
        return None

    def record(w: _Worker, kind: str, detail: str, backoff: float):
        crashes.append(ProcessCrashRecord(
            attempt=len(crashes) + 1, error_type=kind, error=detail,
            crashed_at_step=store_step(), restored_step=None,
            restored_epoch=None, backoff_s=backoff, worker=w.index,
            flight_tail=flight_tail()))

    def schedule_respawn(w: _Worker, kind: str, detail: str):
        nonlocal restarts
        restarts += 1
        if restarts > policy.max_restarts:
            record(w, kind, detail, 0.0)
            give_up(f"restart budget exhausted after {policy.max_restarts} "
                    f"restarts (last: worker {w.index} {kind}: {detail})")
        delay = (backoff_delay(restarts - 1, base_s=policy.backoff_s,
                               cap_s=policy.max_backoff_s, rng=rng)
                 if policy.backoff_s > 0 else 0.0)
        record(w, kind, detail, delay)
        w.status = "pending"
        w.respawn_at = time.monotonic() + delay
        log.warning("worker %d %s (%s) — respawn %d/%d in %.2fs", w.index,
                    kind, detail, restarts, policy.max_restarts, delay)
        if on_restart is not None:
            on_restart(w.index, w.attempt + 1)

    try:
        return _supervise(workers, spawn, kill_all, summary, give_up,
                          record, schedule_respawn, store_step, crashes,
                          policy, respawn_preempted, attempt_timeout_s,
                          overall_timeout_s, poll_s, t0)
    except RestartBudgetExceeded:
        raise  # give_up already killed the fleet
    except BaseException:
        # an unexpected failure (bad argv from a callable, exec OSError,
        # KeyboardInterrupt) must not leak live workers to the caller
        kill_all()
        raise


def _supervise(workers, spawn, kill_all, summary, give_up, record,
               schedule_respawn, store_step, crashes, policy,
               respawn_preempted, attempt_timeout_s, overall_timeout_s,
               poll_s, t0):
    for w in workers:
        spawn(w)
    while True:
        now = time.monotonic()
        if overall_timeout_s is not None and now - t0 > overall_timeout_s:
            give_up(f"overall deadline of {overall_timeout_s:.0f}s expired "
                    "with workers still running")
        for w in workers:
            if w.status == "pending" and w.respawn_at is not None \
                    and now >= w.respawn_at:
                # annotate THIS worker's latest crash record with where
                # the store stands — the step this attempt restores to
                # (crashes[-1] may belong to a different worker)
                for rec_ in reversed(crashes):
                    if rec_.worker == w.index:
                        rec_.restored_step = store_step()
                        break
                spawn(w)
            if w.status != "running":
                continue
            rc = w.proc.poll()
            if rc is None:
                if attempt_timeout_s is not None and \
                        now - w.started_at > attempt_timeout_s:
                    try:
                        w.proc.kill()
                        w.proc.wait(timeout=10)
                    except (OSError, subprocess.TimeoutExpired) as e:
                        log.warning("hung worker %d unkillable (%s: %s)",
                                    w.index, type(e).__name__, e)
                    schedule_respawn(
                        w, "AttemptTimeout",
                        f"no exit within {attempt_timeout_s:.0f}s")
                continue
            if rc == 0:
                w.status = "completed"
                log.info("worker %d completed (attempt %d)", w.index,
                         w.attempt)
            elif rc == ELASTIC_RESTART_EXIT:
                schedule_respawn(w, "ElasticRestartRequired",
                                 "worker asked to be respawned "
                                 f"(exit {rc})")
            elif rc < 0:
                signame = signal.Signals(-rc).name if -rc in \
                    signal.Signals._value2member_map_ else str(-rc)
                preemption = -rc in (signal.SIGKILL, signal.SIGTERM)
                if not preemption:
                    # SIGABRT/SIGSEGV etc. are crashes (a poisoned
                    # runtime aborting), not the scheduler taking the
                    # machine — respawn under the budget
                    schedule_respawn(w, "ProcessCrash",
                                     f"killed by {signame}")
                elif respawn_preempted:
                    schedule_respawn(w, "Preempted",
                                     f"killed by {signame}")
                else:
                    w.status = "down"
                    record(w, "Preempted",
                           f"killed by {signame}; not respawned "
                           "(respawn_preempted=False)", 0.0)
                    log.warning("worker %d preempted (%s) — continuing "
                                "with survivors", w.index, signame)
            else:
                schedule_respawn(w, "ProcessCrash", f"exit code {rc}")
        statuses = {w.status for w in workers}
        if "running" not in statuses and "pending" not in statuses:
            if "completed" in statuses:
                s = summary(True)
                log.info("%s", s)
                return s
            give_up("every worker is permanently down and none completed")
        time.sleep(poll_s)
