"""SLO-driven autoscaling over each replica's ``/metrics`` (counterpart of
``deeplearning4j_tpu/fleet/autoscaler.py``).

The scaler consumes ONLY what the obs layer already exports — no new
replica-side protocol. Each :meth:`Autoscaler.step` scrapes every live
replica's Prometheus text, diffs counters and histogram buckets against
the previous scrape of the SAME incarnation (a restarted replica's
counters restart too), and reduces to three fleet signals:

- **shed rate**: Δ``serving_requests_shed`` over Δadmitted+shed — the
  clearest "we are out of capacity" signal the tier emits;
- **p99 latency**: the 99th percentile of the Δ``serving_request_ms``
  bucket counts summed across replicas (interval p99, not
  lifetime p99);
- **occupancy**: mean ``serving_inflight_requests`` per ready replica.

Decisions go through a :class:`ReplicaLauncher`-shaped object (anything
with ``start_replica()`` / ``stop_replica(replica_id)``) so the same
policy drives subprocesses (``tools/fleet.py``), threads (tests) or a
real cluster scheduler. Scale-down only ever picks a victim whose every
model AND index remains hosted by another ready replica — the fleet
never scales itself into a placement hole — and the launcher is
expected to drain (the replica withdraws its lease before its server
stops, so admitted work completes).

Scale-up is cheap because cold start is cheap: a fresh replica restores
the checkpoint, warms off-path and only then flips its lease
(``fleet/replica.py``) — the scaler can be aggressive going up (short
cooldown) and conservative coming down (long cooldown), the classic
asymmetry.

All scrapes carry explicit timeouts (lint DLT016): a wedged replica
must never wedge the control loop.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.fleet.membership import FleetView, ReplicaInfo

log = logging.getLogger(__name__)

__all__ = ["parse_prometheus", "histogram_quantile", "AutoscalerPolicy",
           "Autoscaler"]


def parse_prometheus(text: str) -> Dict[str, object]:
    """Parse Prometheus exposition text into ``{name: float}`` for
    counters/gauges and ``{name: {"buckets": [(le, cum)], "sum": s,
    "count": n}}`` for histograms (the subset ``obs/exporters.py``
    emits)."""
    out: Dict[str, object] = {}
    hists: Dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            continue
        try:
            val = float(value)
        except ValueError:
            continue
        if "_bucket{le=" in name:
            base, _, rest = name.partition("_bucket{le=")
            le_raw = rest.rstrip("}").strip('"')
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
            hists.setdefault(base, {"buckets": [], "sum": 0.0,
                                    "count": 0})["buckets"].append((le, val))
        elif name.endswith("_sum") and name[:-4] in hists:
            hists[name[:-4]]["sum"] = val
        elif name.endswith("_count") and name[:-6] in hists:
            hists[name[:-6]]["count"] = int(val)
        else:
            out[name] = val
    for base, h in hists.items():
        h["buckets"].sort(key=lambda b: b[0])
        out[base] = h
    return out


def histogram_quantile(buckets: List[Tuple[float, float]],
                       q: float) -> float:
    """Quantile from cumulative ``(le, count)`` buckets, linear
    interpolation inside the winning bucket (Prometheus
    ``histogram_quantile`` semantics, simplified). 0.0 when empty."""
    if not buckets:
        return 0.0
    total = buckets[-1][1]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= rank:
            if le == float("inf"):
                return prev_le  # open-ended top bucket: best lower bound
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = (0.0 if le == float("inf") else le), cum
    return prev_le


@dataclasses.dataclass
class AutoscalerPolicy:
    """Thresholds and pacing. Defaults suit the CPU-device tests; real
    deployments tune ``target_p99_ms`` to their SLO."""
    min_replicas: int = 1
    max_replicas: int = 4
    target_p99_ms: float = 250.0
    max_shed_rate: float = 0.01       # >1% shed ⇒ out of capacity
    target_inflight: float = 16.0     # mean per-replica occupancy ceiling
    scale_up_cooldown_s: float = 10.0
    scale_down_cooldown_s: float = 60.0
    # scale down only when the fleet is this idle (fractions of the
    # scale-UP thresholds): hysteresis so the fleet doesn't flap
    scale_down_p99_frac: float = 0.5
    scale_down_inflight_frac: float = 0.25


class Autoscaler:
    """One control loop: ``view`` (who is alive) + scrapes (how they
    feel) → ``launcher.start_replica()`` / ``stop_replica(id)``."""

    def __init__(self, view: FleetView, launcher,
                 policy: Optional[AutoscalerPolicy] = None, *,
                 fetch: Optional[Callable[[str], str]] = None,
                 scrape_timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.view = view
        self.launcher = launcher
        self.policy = policy or AutoscalerPolicy()
        self.clock = clock
        self.scrape_timeout_s = float(scrape_timeout_s)
        self._fetch = fetch or self._http_fetch
        # previous scrape per (replica_id, incarnation): counter deltas
        # must never span a replica restart
        self._prev: Dict[Tuple[str, str], Dict[str, object]] = {}
        self._last_up = float("-inf")
        self._last_down = float("-inf")
        self.decisions: List[dict] = []

        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        self._m_ups = reg.counter(
            "fleet_autoscaler_scale_ups", unit="events",
            help="replicas launched by the autoscaler")
        self._m_downs = reg.counter(
            "fleet_autoscaler_scale_downs", unit="events",
            help="replicas retired by the autoscaler")
        self._m_p99 = reg.gauge(
            "fleet_autoscaler_p99_ms", unit="ms",
            help="interval p99 serving latency the last decision saw")
        self._m_shed = reg.gauge(
            "fleet_autoscaler_shed_rate", unit="fraction",
            help="interval shed fraction the last decision saw")

    def _http_fetch(self, address: str) -> str:
        with urllib.request.urlopen(address + "/metrics",
                                    timeout=self.scrape_timeout_s) as r:
            return r.read().decode()

    # --------------------------------------------------------------- signals
    def _scrape(self, replicas: Dict[str, ReplicaInfo]) -> dict:
        """Fleet-wide interval signals from per-replica scrape deltas."""
        d_shed = d_admitted = 0.0
        inflight = []
        bucket_delta: Dict[float, float] = {}
        seen_keys = set()
        for r in replicas.values():
            key = (r.replica_id, r.incarnation)
            seen_keys.add(key)
            try:
                cur = parse_prometheus(self._fetch(r.address))
            except Exception as e:
                log.warning("scrape of %s failed (%s: %s)", r.replica_id,
                            type(e).__name__, e)
                continue
            prev = self._prev.get(key, {})
            self._prev[key] = cur

            def delta(name):
                c = cur.get(name)
                p = prev.get(name, 0.0)
                return max(0.0, c - p) if isinstance(c, float) else 0.0

            shed = delta("serving_requests_shed")
            served = delta("serving_http_requests")
            d_shed += shed
            d_admitted += served
            infl = cur.get("serving_inflight_requests")
            if isinstance(infl, float):
                inflight.append(infl)
            h = cur.get("serving_request_ms")
            hp = prev.get("serving_request_ms")
            if isinstance(h, dict):
                pb = dict(hp["buckets"]) if isinstance(hp, dict) else {}
                for le, cum in h["buckets"]:
                    bucket_delta[le] = (bucket_delta.get(le, 0.0)
                                        + max(0.0, cum - pb.get(le, 0.0)))
        # forget incarnations that left the fleet
        self._prev = {k: v for k, v in self._prev.items() if k in seen_keys}
        denom = d_admitted + d_shed
        p99 = histogram_quantile(sorted(bucket_delta.items()), 0.99)
        return {"shed_rate": (d_shed / denom) if denom > 0 else 0.0,
                "p99_ms": p99,
                "mean_inflight": (sum(inflight) / len(inflight)
                                  if inflight else 0.0),
                "interval_requests": d_admitted,
                "interval_shed": d_shed}

    # -------------------------------------------------------------- decision
    def _victim(self, ready: Dict[str, ReplicaInfo]) -> Optional[str]:
        """Least-loaded ready replica whose placement stays covered."""
        def covered_without(rid: str) -> bool:
            others = [r for k, r in ready.items() if k != rid]
            gone = ready[rid]
            return all(any(m in o.models for o in others)
                       for m in gone.models) and \
                   all(any(i in o.indexes for o in others)
                       for i in gone.indexes)

        order = sorted(ready.values(),
                       key=lambda r: (r.load.get("inflight", 0),
                                      r.replica_id))
        for r in order:
            if covered_without(r.replica_id):
                return r.replica_id
        return None

    def step(self) -> dict:
        """One evaluation. Returns the decision record (also appended to
        ``self.decisions`` and mirrored into obs gauges)."""
        pol = self.policy
        now = self.clock()
        replicas = self.view.replicas()
        ready = {k: r for k, r in replicas.items() if r.ready}
        sig = self._scrape(ready)
        self._m_p99.set(sig["p99_ms"])
        self._m_shed.set(sig["shed_rate"])
        n_live, n_ready = len(replicas), len(ready)

        decision = {"action": "hold", "reason": "within slo",
                    "live": n_live, "ready": n_ready, **sig}
        overloaded = (sig["shed_rate"] > pol.max_shed_rate
                      or sig["p99_ms"] > pol.target_p99_ms
                      or sig["mean_inflight"] > pol.target_inflight)
        idle = (sig["interval_shed"] == 0
                and sig["p99_ms"] < pol.target_p99_ms
                * pol.scale_down_p99_frac
                and sig["mean_inflight"] < pol.target_inflight
                * pol.scale_down_inflight_frac)

        if n_live < pol.min_replicas:
            decision.update(action="up", reason="below min_replicas")
        elif overloaded and n_live < pol.max_replicas:
            if now - self._last_up >= pol.scale_up_cooldown_s:
                why = ("shed" if sig["shed_rate"] > pol.max_shed_rate
                       else "p99" if sig["p99_ms"] > pol.target_p99_ms
                       else "occupancy")
                decision.update(action="up", reason=f"slo breach: {why}")
            else:
                decision.update(reason="slo breach, in up-cooldown")
        elif overloaded:
            decision.update(reason="slo breach, at max_replicas")
        elif idle and n_live > pol.min_replicas and n_ready > 1:
            if now - self._last_down >= pol.scale_down_cooldown_s:
                victim = self._victim(ready)
                if victim is None:
                    decision.update(reason="idle, but no victim keeps "
                                           "placement covered")
                else:
                    decision.update(action="down", reason="fleet idle",
                                    victim=victim)
            else:
                decision.update(reason="idle, in down-cooldown")

        if decision["action"] == "up":
            self._last_up = now
            self._m_ups.inc()
            started = self.launcher.start_replica()
            decision["started"] = started
        elif decision["action"] == "down":
            self._last_down = now
            self._m_downs.inc()
            self.launcher.stop_replica(decision["victim"])
        self.decisions.append(decision)
        log.info("autoscaler: %s (%s) live=%d ready=%d p99=%.1fms "
                 "shed=%.3f", decision["action"], decision["reason"],
                 n_live, n_ready, sig["p99_ms"], sig["shed_rate"])
        return decision
