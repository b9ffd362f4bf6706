"""Collective-timeout watchdog for multi-process training (counterpart
of ``deeplearning4j_tpu/parallel/watchdog.py``; reference guardrail
``ParallelWrapper.java:105-110``, worker supervision).

A peer process that dies leaves a collective (an NCCL or gloo all-reduce,
a barrier) with no matching participant, and the waiting rank blocks with
no error. The watchdog bounds that wait: the blocking call runs on a
worker thread under a deadline; on expiry it logs a diagnostic (rank and
world, the devices, the elapsed time, what was awaited), flushes the
flight recorder and raises :class:`CollectiveTimeoutError`, or ends the
process with ``abort=True`` so a supervisor can respawn it (a kernel or a
collective stuck on a card cannot be cancelled from Python; only process
death frees it).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class CollectiveTimeoutError(RuntimeError):
    pass


class CollectiveWatchdog:
    """Deadline guard around host-side syncs of device work.

    Usage::

        wd = CollectiveWatchdog(timeout_s=120)
        ...launch a step with a collective...
        wd.sync(params, what="train step 42")   # bounded wait

    or as a context manager around any blocking call::

        with wd.guard("eval all_gather"):
            value = float(loss)
    """

    def __init__(self, timeout_s: float = 300.0, abort: bool = False,
                 on_timeout: Optional[Callable[[str], None]] = None):
        self.timeout_s = float(timeout_s)
        self.abort = abort
        self.on_timeout = on_timeout

    # ------------------------------------------------------------ diagnostics
    def _diagnose(self, what: str, elapsed: float) -> str:
        import torch
        import torch.distributed as dist
        try:
            if dist.is_available() and dist.is_initialized():
                pidx, pcnt = dist.get_rank(), dist.get_world_size()
            else:
                pidx, pcnt = 0, 1
            devs = (",".join(f"cuda:{i}" for i in range(torch.cuda.device_count()))
                    if torch.cuda.is_available() else "cpu")
        except Exception:
            pidx = pcnt = -1
            devs = "?"
        return (f"collective watchdog: '{what}' did not complete within "
                f"{self.timeout_s:.0f}s (elapsed {elapsed:.1f}s) — likely a "
                f"hung collective (dead peer or partition). "
                f"process {pidx}/{pcnt}, local devices [{devs}]")

    def _expire(self, what: str, elapsed: float):
        msg = self._diagnose(what, elapsed)
        log.error(msg)
        # a hung collective is a post-mortem moment: put the diagnostic in
        # the crash ring and flush it NOW — with abort=True nothing after
        # this line runs, and even the raise path may end in process death
        try:
            from deeplearning4j_tpu_torch.obs.flight import (flush_flight_recorder,
                                                       get_flight_recorder)
            fr = get_flight_recorder()
            if fr is not None:
                fr.event("watchdog.timeout", what=what,
                         elapsed_s=round(elapsed, 2),
                         timeout_s=self.timeout_s)
            flush_flight_recorder(f"watchdog timeout: {what}")
        except Exception:
            log.exception("flight-recorder flush on watchdog timeout "
                          "failed")
        if self.on_timeout is not None:
            try:
                self.on_timeout(msg)
            except Exception:
                log.exception("watchdog on_timeout callback failed")
        if self.abort:
            # a hung collective cannot be cancelled from Python; process
            # death is the only way to free the card for a restart
            log.error("watchdog aborting process (abort=True)")
            os._exit(42)
        raise CollectiveTimeoutError(msg)

    # ------------------------------------------------------------------ sync
    def sync(self, tree, what: str = "device sync"):
        """Bounded wait for the work queued on every CUDA device that holds
        a tensor of ``tree`` (``torch.cuda.synchronize``; nothing to wait
        for on the CPU, where the step has run when it returns). Returns
        the tree on success; raises CollectiveTimeoutError (or aborts) on
        deadline."""
        import torch
        from deeplearning4j_tpu_torch.obs.trace import _cuda_devices

        def wait():
            for dev in _cuda_devices(tree, set()):
                torch.cuda.synchronize(dev)
        self.call(wait, what)
        return tree

    # ------------------------------------------------------------------ call
    def call(self, fn: Callable, what: str = "guarded call"):
        """Run a blocking callable under the deadline on a worker thread —
        needed when the HANG can occur inside the call itself (a gloo
        collective blocks the calling thread until its peers arrive, so a
        later ``sync`` would never be reached). Returns fn's result; raises CollectiveTimeoutError (or
        aborts) on deadline. The wedged worker thread cannot be cancelled —
        deployments that must free the chip use ``abort=True``."""
        done = threading.Event()
        out: dict = {}

        def run():
            try:
                out["v"] = fn()
            except BaseException as e:  # surfaced on the caller thread
                out["e"] = e
            finally:
                done.set()

        t0 = time.monotonic()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        if not done.wait(self.timeout_s):
            self._expire(what, time.monotonic() - t0)
        if "e" in out:
            raise out["e"]
        return out.get("v")

    # --------------------------------------------------------------- guard()
    class _Guard:
        def __init__(self, wd: "CollectiveWatchdog", what: str):
            self.wd = wd
            self.what = what
            self._timer: Optional[threading.Timer] = None
            self._t0 = 0.0
            self._fired = threading.Event()

        def __enter__(self):
            self._t0 = time.monotonic()

            def fire():
                self._fired.set()
                # raising in the caller thread is impossible from a timer;
                # log + optional abort here, caller sees the flag on exit
                try:
                    self.wd._expire(self.what, time.monotonic() - self._t0)
                except CollectiveTimeoutError:
                    pass
            self._timer = threading.Timer(self.wd.timeout_s, fire)
            self._timer.daemon = True
            self._timer.start()
            return self

        def __exit__(self, exc_type, exc, tb):
            if self._timer is not None:
                self._timer.cancel()
            if self._fired.is_set() and exc_type is None:
                raise CollectiveTimeoutError(self.wd._diagnose(
                    self.what, time.monotonic() - self._t0))
            return False

    def guard(self, what: str = "guarded section") -> "_Guard":
        """Context manager: if the body outlives the deadline, diagnostics
        fire immediately (and the process aborts when ``abort=True``);
        otherwise exiting in time cancels the timer."""
        return CollectiveWatchdog._Guard(self, what)
