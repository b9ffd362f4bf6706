"""Circuit breaker for the serving tier (counterpart of
``deeplearning4j_tpu/serving/breaker.py``, stdlib only; the port also keeps
:class:`BreakerOpenError` here, which the JAX package defines in
``serving/server.py``).

A model that starts failing every dispatch (poisoned checkpoint, OOM'd
device, a bug tripped by a particular input mix) must not drag every
client through a full queue wait + dispatch + failure: after
``failure_threshold`` failures inside ``window_s`` the breaker OPENS and
the server answers 503 immediately — the fast-fail half of graceful
degradation. After ``cooldown_s`` one request is let through as a
half-open PROBE; its success closes the breaker, its failure re-opens it.

States (the classic three):

- ``closed``  — healthy; failures are counted in a sliding window;
- ``open``    — rejecting everything until the cooldown elapses;
- ``half_open`` — exactly one probe in flight; everyone else still
  rejected. A probe that never resolves (caller died, deadline expired
  before dispatch) is abandoned after ``probe_timeout_s`` so the breaker
  can never wedge half-open forever.

Thread-safe; the clock is injectable (``clock=``) so tests drive the
cooldown deterministically instead of sleeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque

__all__ = ["CircuitBreaker", "BreakerOpenError"]


class BreakerOpenError(RuntimeError):
    """The endpoint's circuit breaker is open (or probing): fast 503."""

    def __init__(self, retry_after_s: float):
        super().__init__("circuit breaker open")
        self.retry_after_s = float(retry_after_s)


class CircuitBreaker:
    """``allow()`` before dispatch; ``record_success()`` /
    ``record_failure()`` after. See module docstring for the state
    machine. Counters: ``opens``, ``rejections``, ``probes``."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, window_s: float = 10.0,
                 cooldown_s: float = 5.0, probe_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if window_s <= 0 or cooldown_s < 0 or probe_timeout_s <= 0:
            raise ValueError("window_s/probe_timeout_s must be > 0 and "
                             "cooldown_s >= 0")
        self.failure_threshold = int(failure_threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CircuitBreaker.CLOSED
        self._failures: Deque[float] = deque()
        self._opened_at = 0.0
        self._probe_at = 0.0
        self._probe_in_flight = False
        self.opens = 0
        self.rejections = 0
        self.probes = 0

    # ------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def retry_after(self) -> float:
        """Seconds until a request is worth retrying (the 503 Retry-After
        value): remaining cooldown when open, a short beat otherwise."""
        with self._lock:
            if self._state == CircuitBreaker.OPEN:
                return max(0.0, self._opened_at + self.cooldown_s
                           - self._clock())
            return 1.0

    # ------------------------------------------------------------ protocol
    def allow(self) -> bool:
        """May this request proceed to dispatch? Open → False (fast 503)
        until the cooldown elapses, then exactly one half-open probe."""
        with self._lock:
            now = self._clock()
            if self._state == CircuitBreaker.CLOSED:
                return True
            if self._state == CircuitBreaker.OPEN:
                if now < self._opened_at + self.cooldown_s:
                    self.rejections += 1
                    return False
                self._state = CircuitBreaker.HALF_OPEN
                self._probe_in_flight = False  # fall through: claim probe
            # half-open: admit one probe; re-claim an abandoned one
            if self._probe_in_flight and \
                    now < self._probe_at + self.probe_timeout_s:
                self.rejections += 1
                return False
            self._probe_in_flight = True
            self._probe_at = now
            self.probes += 1
            return True

    def record_success(self):
        with self._lock:
            if self._state == CircuitBreaker.HALF_OPEN:
                self._state = CircuitBreaker.CLOSED
                self._probe_in_flight = False
                self._failures.clear()
            elif self._state == CircuitBreaker.CLOSED:
                # healthy traffic ages failures out of the window anyway;
                # clearing eagerly keeps a slow drip below threshold
                self._prune(self._clock())

    def record_failure(self):
        with self._lock:
            now = self._clock()
            if self._state == CircuitBreaker.HALF_OPEN:
                # the probe failed: full cooldown again
                self._state = CircuitBreaker.OPEN
                self._opened_at = now
                self._probe_in_flight = False
                self.opens += 1
                return
            if self._state == CircuitBreaker.OPEN:
                # stragglers admitted before the open must not extend it
                return
            self._failures.append(now)
            self._prune(now)
            if len(self._failures) >= self.failure_threshold:
                self._state = CircuitBreaker.OPEN
                self._opened_at = now
                self._failures.clear()
                self.opens += 1

    def _prune(self, now: float):
        while self._failures and self._failures[0] < now - self.window_s:
            self._failures.popleft()

    def as_dict(self) -> dict:
        with self._lock:
            return {"state": self._state, "opens": self.opens,
                    "rejections": self.rejections, "probes": self.probes,
                    "window_failures": len(self._failures)}
