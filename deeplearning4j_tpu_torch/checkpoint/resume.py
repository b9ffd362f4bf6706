"""Auto-resume training driver: preemption becomes a no-op for callers
(counterpart of ``deeplearning4j_tpu/checkpoint/resume.py``).

``CheckpointManager`` makes crash-resume *possible* — kill training at an
arbitrary step, ``restore_latest()``, refit, and the result is
bitwise-identical to the uninterrupted run. :func:`train_until` makes it
*automatic*: it owns the crash → backoff → restore → refit loop, so
preemptions, transient storage outages (surfaced as ``CheckpointError``)
and hung calls (surfaced by a watchdog's deadline) all collapse into
restart cycles recorded in a :class:`RunSummary` instead of a dead job.

Mechanics that keep the bitwise guarantee intact:

- a step-0 checkpoint is committed up front (``save_initial``), so even a
  crash before the first periodic save restores to the pristine
  parameters and generator state rather than needing a fresh model whose
  training would then silently differ from "the run that was promised";
- every restart restores via ``restore_latest()`` — the torn/bit-rot
  fallback applies, so flaky storage under the checkpoints degrades to an
  older restore point, never to garbage;
- the restart budget (:class:`RestartPolicy`) bounds the loop: crash
  storms escalate to :class:`RestartBudgetExceeded` carrying the full
  crash history, instead of looping forever on a permanently-broken job.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.utils.backoff import backoff_delay

log = logging.getLogger(__name__)

__all__ = ["RestartPolicy", "CrashRecord", "RunSummary",
           "RestartBudgetExceeded", "train_until"]


@dataclasses.dataclass
class RestartPolicy:
    """How :func:`train_until` reacts to a crash.

    ``max_restarts`` bounds recovery attempts; ``backoff_s`` is the base of
    a capped exponential backoff between them (with jitter via
    utils/backoff.py — restarting a preempted fleet in lockstep recreates
    the stampede that got it preempted); ``restart_on`` is the exception
    allowlist (default: any ``Exception`` — ``KeyboardInterrupt`` /
    ``SystemExit`` always propagate)."""
    max_restarts: int = 5
    backoff_s: float = 1.0
    max_backoff_s: float = 60.0
    restart_on: tuple = (Exception,)
    seed: int = 0

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff must be >= 0")


@dataclasses.dataclass
class CrashRecord:
    """One crash/restore cycle in a run's history."""
    attempt: int            # 1-based restart number this crash triggered
    error_type: str
    error: str
    crashed_at_step: Optional[int]   # model.iteration when the crash hit
    restored_step: Optional[int]     # checkpoint step recovery resumed from
    restored_epoch: Optional[int]
    backoff_s: float
    # the victim's last seconds: one-liner summaries of the newest crash
    # flight-recorder ring entries (obs/flight.py)
    flight_tail: Optional[List[str]] = None


@dataclasses.dataclass
class RunSummary:
    """What happened across the whole ``train_until`` run — the record an
    operator reads after the fact to see how rough the ride was."""
    model: object
    completed: bool
    restarts: int
    crashes: List[CrashRecord]
    wall_time_s: float

    def __str__(self):
        tail = "; ".join(
            f"#{c.attempt} {c.error_type}@step{c.crashed_at_step}"
            f"->resume@{c.restored_step}" for c in self.crashes)
        return (f"train_until: completed={self.completed} "
                f"restarts={self.restarts} wall={self.wall_time_s:.1f}s"
                + (f" [{tail}]" if tail else ""))


class RestartBudgetExceeded(RuntimeError):
    """The restart budget ran out (or recovery itself is impossible);
    ``summary`` carries the full crash history for escalation."""

    def __init__(self, message: str, summary: RunSummary):
        super().__init__(message)
        self.summary = summary


def train_until(model, data, num_epochs: int, checkpoint_manager,
                restart_policy: Optional[RestartPolicy] = None,
                watchdog=None,
                on_restart: Optional[Callable] = None,
                save_initial: bool = True,
                fit_kwargs: Optional[dict] = None) -> RunSummary:
    """Train ``model`` to ``num_epochs`` TOTAL epochs, surviving crashes by
    restoring from ``checkpoint_manager`` and refitting — the caller sees a
    completed run (with its crash history in the returned
    :class:`RunSummary`) or a loud :class:`RestartBudgetExceeded`.

    ``model`` may already be restored/part-trained: ``fit``'s resume
    semantics apply (``num_epochs`` is the run's total target). ``data``
    must replay deterministically (the bitwise-resume precondition every
    ``fit`` wire-in documents).

    ``watchdog`` (anything with ``call(fn, what=...)`` that runs ``fn``
    under a deadline and raises when it passes, as the JAX package's
    ``CollectiveWatchdog`` does) runs each fit attempt under its deadline:
    a hung call becomes an exception, which is just another restartable
    crash here. Pass a generous deadline (a whole fit attempt, not one
    step).

    ``on_restart(model, attempt)`` is called after each restore, before
    the refit — chaos tests use it to re-arm fault injectors on the fresh
    model object; production code can re-attach listeners the restored
    model does not carry.

    ``save_initial`` commits a step-0 checkpoint before the first attempt
    when the store has none, so a crash before the first periodic save
    still restores to the pristine state (otherwise recovery would need a
    fresh model whose run could differ from the promised one). The initial
    save is synchronous (``wait=True``) — it doubles as a fail-fast probe
    that storage is writable at all.
    """
    policy = restart_policy if restart_policy is not None else RestartPolicy()
    fit_kwargs = dict(fit_kwargs or {})
    rng = random.Random(policy.seed)
    cm = checkpoint_manager
    crashes: List[CrashRecord] = []
    t0 = time.monotonic()

    def summary(completed: bool) -> RunSummary:
        return RunSummary(model=model, completed=completed,
                          restarts=len(crashes), crashes=crashes,
                          wall_time_s=time.monotonic() - t0)

    if save_initial and not cm.checkpoints():
        if getattr(model, "params", None) is None:
            model.init()
        cm.save(model, wait=True)

    attempt = 0
    try:
        while True:
            # fence the manager to THIS attempt's model: a watchdog-timed-
            # out fit thread cannot be cancelled, only outlived — if it
            # wakes later, its step_end/save calls are dropped instead of
            # committing a stale-lineage checkpoint the next restore would
            # pick up behind the recovered run's back
            cm.fence(model)
            try:
                def _fit():
                    return model.fit(data, num_epochs=num_epochs,
                                     checkpoint_manager=cm, **fit_kwargs)
                if watchdog is not None:
                    watchdog.call(_fit, what=f"train_until fit attempt "
                                             f"{attempt + 1}")
                else:
                    _fit()
                s = summary(True)
                log.info("%s", s)
                return s
            except policy.restart_on as e:
                attempt += 1
                crashed_at = getattr(model, "iteration", None)
                if attempt > policy.max_restarts:
                    crashes.append(CrashRecord(
                        attempt=attempt, error_type=type(e).__name__,
                        error=str(e), crashed_at_step=crashed_at,
                        restored_step=None, restored_epoch=None,
                        backoff_s=0.0))
                    s = summary(False)
                    log.error("train_until giving up: %s", s)
                    raise RestartBudgetExceeded(
                        f"restart budget exhausted after "
                        f"{policy.max_restarts} restarts (last crash: "
                        f"{type(e).__name__}: {e})", s) from e
                delay = (backoff_delay(attempt - 1, base_s=policy.backoff_s,
                                       cap_s=policy.max_backoff_s, rng=rng)
                         if policy.backoff_s > 0 else 0.0)
                log.warning(
                    "train_until crash %d/%d (%s: %s) at step %s — "
                    "restoring latest checkpoint after %.2fs backoff",
                    attempt, policy.max_restarts, type(e).__name__, e,
                    crashed_at, delay)
                if delay:
                    time.sleep(delay)
                # the crash's own record goes in FIRST (causal order) with
                # its own attempt number; restore retries below append
                # RestoreFailed records after it, each consuming a further
                # attempt. restored_step is filled in once restore lands.
                crash_rec = CrashRecord(
                    attempt=attempt, error_type=type(e).__name__,
                    error=str(e), crashed_at_step=crashed_at,
                    restored_step=None, restored_epoch=None,
                    backoff_s=delay)
                # same process, so the flight ring is directly readable:
                # attach what the victim was doing when it crashed
                try:
                    from deeplearning4j_tpu_torch.obs.flight import (
                        get_flight_recorder)
                    fr = get_flight_recorder()
                    if fr is not None and fr.recorded:
                        crash_rec.flight_tail = fr.tail_summary(8)
                except Exception as fe:
                    log.debug("could not attach flight tail (%s: %s)",
                              type(fe).__name__, fe)
                crashes.append(crash_rec)
                # a failed RESTORE is itself recoverable (a transient
                # storage outage makes restore_latest raise or fall all
                # the way through to None) — it consumes restart budget
                # with backoff, like any other crash, rather than
                # bypassing the budget with an instant give-up
                restored = None
                while restored is None:
                    restore_err_type = "RestoreFailed"
                    restore_err = "restore_latest returned no checkpoint"
                    try:
                        restored = cm.restore_latest()
                    except policy.restart_on as re_err:
                        # keep the REAL error in the crash history — the
                        # operator must be able to tell a storage outage
                        # from an empty store
                        restore_err_type = type(re_err).__name__
                        restore_err = f"restore_latest failed: {re_err}"
                        log.warning("restore_latest failed (%s: %s)",
                                    type(re_err).__name__, re_err)
                        restored = None
                    if restored is not None:
                        break
                    attempt += 1
                    if attempt > policy.max_restarts:
                        s = summary(False)
                        raise RestartBudgetExceeded(
                            "no restorable checkpoint within the restart "
                            "budget (transient storage outage outlasting "
                            "the budget, storage lost every committed "
                            "checkpoint, or save_initial=False before the "
                            "first periodic save) — cannot recover "
                            "without silently restarting a different run",
                            s) from e
                    retry_delay = (backoff_delay(
                        attempt - 1, base_s=policy.backoff_s,
                        cap_s=policy.max_backoff_s, rng=rng)
                        if policy.backoff_s > 0 else 0.0)
                    log.warning(
                        "no restorable checkpoint yet — retrying restore "
                        "(%d/%d) after %.2fs backoff", attempt,
                        policy.max_restarts, retry_delay)
                    crashes.append(CrashRecord(
                        attempt=attempt, error_type=restore_err_type,
                        error=restore_err,
                        crashed_at_step=crashed_at, restored_step=None,
                        restored_epoch=None, backoff_s=retry_delay))
                    if retry_delay:
                        time.sleep(retry_delay)
                rs = restored._restored_from
                if rs is not None:
                    crash_rec.restored_step = rs.step
                    crash_rec.restored_epoch = rs.epoch
                model = restored
                if on_restart is not None:
                    on_restart(model, attempt)
    finally:
        # lift the fence on every exit: the manager goes back to the
        # caller, who may legitimately save other models through it
        cm.fence(None)
