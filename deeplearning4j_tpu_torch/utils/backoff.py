"""Capped exponential backoff with jitter — the repo's single retry-delay
policy.

Counterpart of ``deeplearning4j_tpu/utils/backoff.py``, the same schedule
for the same arguments and seeded ``rng``. Used by
``checkpoint/storage.py``'s :class:`RetryingBackend` (transient
object-store faults), ``checkpoint/resume.py``'s restart loop and
``storage/remote.py``'s ``RemoteUIStatsStorageRouter`` (flaky UI-server
posts). Linear
growth under a correlated outage (the store is down, every worker retries)
synchronizes retries into load spikes exactly when the dependency is least
able to absorb them; exponential growth with jitter spreads them out.

Delay for retry ``attempt`` (0-based) is uniform in
``[jitter * d, d]`` where ``d = min(cap_s, base_s * 2**attempt)`` —
"equal-jitter"-style: bounded above by the deterministic exponential
schedule, never collapsing to zero (a zero floor can hot-spin a tight retry
loop), and fully deterministic given a seeded ``rng``.
"""

from __future__ import annotations

import random
from typing import Iterator, Optional

__all__ = ["backoff_delay", "backoff_delays"]


def backoff_delay(attempt: int, base_s: float = 0.5, cap_s: float = 30.0,
                  jitter: float = 0.5,
                  rng: Optional[random.Random] = None) -> float:
    """Seconds to sleep before retry ``attempt`` (0-based: the delay between
    the first failure and the second try is ``attempt=0``).

    ``jitter`` is the lower fraction of the window: 0.5 draws uniformly from
    ``[d/2, d]``; 1.0 disables jitter (deterministic schedule, useful in
    tests); 0.0 allows the full ``[0, d]`` spread."""
    if attempt < 0:
        raise ValueError("attempt must be >= 0")
    if not 0.0 <= jitter <= 1.0:
        raise ValueError("jitter must be in [0, 1]")
    d = min(float(cap_s), float(base_s) * (2.0 ** attempt))
    if jitter >= 1.0 or d <= 0.0:
        return max(0.0, d)
    r = (rng or random).random()
    return d * (jitter + (1.0 - jitter) * r)


def backoff_delays(retries: int, base_s: float = 0.5, cap_s: float = 30.0,
                   jitter: float = 0.5,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """The full delay schedule for a bounded retry loop, as an iterator."""
    for attempt in range(retries):
        yield backoff_delay(attempt, base_s=base_s, cap_s=cap_s,
                            jitter=jitter, rng=rng)
