"""FleetRouter: health-aware weighted routing over live replica leases
(counterpart of ``deeplearning4j_tpu/fleet/router.py``).

A thin front tier — no model code, no JSON decode of predict bodies —
that turns N single-process ``ModelServer`` replicas into one endpoint:

- **Placement-aware.** Requests for ``/v1/models/<m>`` go only to
  replicas whose lease says they host ``m``; same for
  ``/v1/indexes/<i>``. Big models get dedicated replicas simply by
  placement — a slow giant can no longer inflate a small model's p99
  (the per-model-isolation leftover from the single-server tier).
- **Health-aware weighted pick.** Only ``warmed`` + non-``draining``
  leases are candidates (the never-route-to-cold guarantee); among
  them the pick is weighted by free connection slots, so a loaded
  replica organically receives less. Per-replica connections are
  bounded; a replica at its cap is skipped, and when EVERY candidate
  is capped the router sheds with its own 429 — bounded everywhere,
  exactly like the admission queue it fronts.
- **Taxonomy untouched.** Upstream responses (200/400/404/413/429/
  503/504, bodies, Retry-After) are relayed byte-for-byte. Router-
  originated errors use the same ``{"error", "reason"}`` shape with
  distinct reasons (``no_replica``, ``router_saturated``,
  ``upstream_failed``).
- **Retry-on-transient, never non-idempotent admitted work.** A retry
  always targets a DIFFERENT, untried healthy replica with
  ``utils/backoff.py`` delays. What counts as transient depends on
  where the failure happened:

  * connect/send failure — the request provably never reached
    admission: retryable for every route;
  * upstream 429/503 — typed NOT-admitted sheds: retryable for every
    route (the router's whole job is finding capacity elsewhere);
  * failure after the request was fully sent (response never arrived)
    — the replica MAY have admitted it: retried only on idempotent
    routes (predict/query are pure reads), otherwise answered 502;
  * 504 — never retried: the deadline is end-to-end and already spent.

All outbound sockets carry explicit timeouts (lint DLT016): a hung
replica costs one bounded handler thread, never the router.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.fleet.membership import FleetView, ReplicaInfo
from deeplearning4j_tpu_torch.utils.backoff import backoff_delay

log = logging.getLogger(__name__)

__all__ = ["FleetRouter"]

# response headers worth relaying (hop-by-hop headers are not)
_RELAY_HEADERS = ("Content-Type", "Retry-After")


class _Upstream:
    """One forwarding attempt's outcome."""
    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body


class FleetRouter:
    """Front HTTP process routing over a :class:`FleetView`."""

    def __init__(self, view: FleetView, *, port: int = 0,
                 bind_address: str = "127.0.0.1",
                 refresh_s: float = 0.25,
                 request_timeout_s: float = 35.0,
                 max_attempts: int = 3,
                 per_replica_inflight: int = 64,
                 quarantine_s: float = 2.0,
                 backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 0.25,
                 max_body_bytes: int = 8 << 20,
                 seed: Optional[int] = None):
        self.view = view
        self.port = port
        self.bind_address = bind_address
        self.refresh_s = float(refresh_s)
        self.request_timeout_s = float(request_timeout_s)
        self.max_attempts = int(max_attempts)
        self.per_replica_inflight = int(per_replica_inflight)
        self.quarantine_s = float(quarantine_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.max_body_bytes = int(max_body_bytes)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._table: Dict[str, ReplicaInfo] = {}     # ready replicas
        self._live_count = 0
        self._inflight: Dict[str, int] = {}
        self._quarantined_until: Dict[str, float] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._refresh_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        self._m_requests = reg.counter(
            "fleet_router_requests", unit="requests",
            help="requests received by the fleet router")
        self._m_retries = reg.counter(
            "fleet_router_retries", unit="requests",
            help="forwarding attempts retried against a different replica "
                 "after a transient failure or typed shed")
        self._m_no_replica = reg.counter(
            "fleet_router_no_replica", unit="requests",
            help="requests answered 503/404 because no ready replica "
                 "hosts the target")
        self._m_saturated = reg.counter(
            "fleet_router_saturated", unit="requests",
            help="requests shed 429 because every candidate replica was "
                 "at its bounded connection cap")
        self._m_upstream_failures = reg.counter(
            "fleet_router_upstream_failures", unit="requests",
            help="forwarding attempts that failed in transport "
                 "(connect/send/response)")
        self._m_request_ms = reg.histogram(
            "fleet_router_request_ms", unit="ms",
            help="end-to-end router latency including retries")
        self._m_ready = reg.gauge(
            "fleet_router_ready_replicas", unit="replicas",
            help="replicas currently routable (warmed, not draining, "
                 "fresh lease)")

    # ------------------------------------------------------- routing table
    def _refresh(self):
        replicas = self.view.replicas()
        ready = {k: r for k, r in replicas.items() if r.ready}
        with self._lock:
            self._table = ready
            self._live_count = len(replicas)
        self._m_ready.set(len(ready))

    def table(self) -> Dict[str, ReplicaInfo]:
        with self._lock:
            return dict(self._table)

    def _candidates(self, kind: str, name: str) -> List[ReplicaInfo]:
        table = self.table()
        want = (lambda r: r.hosts_model(name)) if kind == "model" \
            else (lambda r: r.hosts_index(name))
        found = [r for r in table.values() if want(r)]
        if not found:
            # a just-warmed replica may not have hit the poll cadence yet
            self._refresh()
            found = [r for r in self.table().values() if want(r)]
        return found

    def _pick(self, candidates: List[ReplicaInfo],
              tried: set) -> Optional[ReplicaInfo]:
        """Weighted-random by free connection slots among untried,
        unquarantined, under-cap candidates."""
        now = time.monotonic()
        pool, weights = [], []
        with self._lock:
            for r in candidates:
                if r.replica_id in tried:
                    continue
                if self._quarantined_until.get(r.replica_id, 0.0) > now:
                    continue
                free = (self.per_replica_inflight
                        - self._inflight.get(r.replica_id, 0))
                if free <= 0:
                    continue
                pool.append(r)
                weights.append(free)
        if not pool:
            return None
        return self._rng.choices(pool, weights=weights, k=1)[0]

    def _note_failure(self, replica_id: str):
        self._m_upstream_failures.inc()
        with self._lock:
            self._quarantined_until[replica_id] = (time.monotonic()
                                                   + self.quarantine_s)

    def _note_success(self, replica_id: str):
        with self._lock:
            self._quarantined_until.pop(replica_id, None)

    # ---------------------------------------------------------- forwarding
    def _attempt(self, replica: ReplicaInfo, method: str, path: str,
                 body: Optional[bytes], content_type: Optional[str]
                 ) -> Tuple[Optional[_Upstream], bool]:
        """One upstream attempt. Returns (response|None, sent): ``sent``
        is whether the request was fully transmitted — the admission
        ambiguity bit the retry policy keys on."""
        host, port = replica.host_port
        headers = {"Connection": "close"}
        if content_type:
            headers["Content-Type"] = content_type
        conn = http.client.HTTPConnection(
            host, port, timeout=self.request_timeout_s)
        try:
            try:
                conn.request(method, path, body=body, headers=headers)
            except Exception as e:
                log.debug("connect/send to %s failed: %s",
                          replica.replica_id, e)
                return None, False
            try:
                resp = conn.getresponse()
                data = resp.read()
            except Exception as e:
                log.debug("response from %s failed: %s",
                          replica.replica_id, e)
                return None, True
            relay = {h: resp.headers[h] for h in _RELAY_HEADERS
                     if resp.headers.get(h)}
            return _Upstream(resp.status, relay, data), True
        finally:
            conn.close()

    def _forward(self, kind: str, name: str, method: str, path: str,
                 body: Optional[bytes], content_type: Optional[str],
                 idempotent: bool) -> _Upstream:
        candidates = self._candidates(kind, name)
        if not candidates:
            self._m_no_replica.inc()
            with self._lock:
                any_live = self._live_count > 0
            if any_live:
                # the fleet exists but nothing READY hosts the target
                # (cold, draining, or placement gap): retryable outage
                return _err(503, "no_replica",
                            f"no ready replica hosts {kind} '{name}'",
                            retry_after_s=1.0)
            return _err(404, "not_found",
                        f"no replica hosts {kind} '{name}'")

        tried: set = set()
        last: Optional[_Upstream] = None
        saturated = False
        for attempt in range(self.max_attempts):
            pick = self._pick(candidates, tried)
            if pick is None:
                if not tried:
                    # nothing tryable at all: distinguish capped (429,
                    # back off and come again) from quarantined (503)
                    with self._lock:
                        saturated = any(
                            self._inflight.get(r.replica_id, 0)
                            >= self.per_replica_inflight
                            for r in candidates)
                break
            tried.add(pick.replica_id)
            if attempt > 0:
                self._m_retries.inc()
                time.sleep(backoff_delay(attempt - 1,
                                         base_s=self.backoff_base_s,
                                         cap_s=self.backoff_cap_s,
                                         rng=self._rng))
            with self._lock:
                self._inflight[pick.replica_id] = \
                    self._inflight.get(pick.replica_id, 0) + 1
            try:
                resp, sent = self._attempt(pick, method, path, body,
                                           content_type)
            finally:
                with self._lock:
                    self._inflight[pick.replica_id] -= 1
            if resp is None:
                self._note_failure(pick.replica_id)
                if sent and not idempotent:
                    # fully sent, no response: the replica may have
                    # admitted (and be executing) this work — a retry
                    # could double-execute a non-idempotent route
                    return _err(502, "upstream_failed",
                                "replica failed after the request was "
                                "sent; route is not idempotent, not "
                                "retried")
                continue
            if resp.status in (429, 503):
                # typed NOT-admitted shed: safe to try a peer with spare
                # capacity; relayed untouched when no peer remains
                self._note_success(pick.replica_id)
                last = resp
                continue
            self._note_success(pick.replica_id)
            return resp
        if last is not None:
            return last
        if saturated:
            self._m_saturated.inc()
            return _err(429, "router_saturated",
                        "every candidate replica is at its connection "
                        "cap", retry_after_s=1.0)
        self._m_upstream_failures.inc()
        return _err(503, "upstream_failed",
                    f"all {len(tried) or len(candidates)} candidate "
                    f"replica(s) failed in transport", retry_after_s=1.0)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetRouter":
        self._refresh()
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router_ref": self})
        server_cls = type("BacklogThreadingHTTPServer",
                          (ThreadingHTTPServer,),
                          {"request_queue_size": 128})
        self._httpd = server_cls((self.bind_address, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fleet-router", daemon=True)
        self._thread.start()
        self._stop.clear()

        def refresh_loop():
            while not self._stop.wait(self.refresh_s):
                try:
                    self._refresh()
                except Exception as e:
                    log.warning("routing-table refresh failed (%s: %s)",
                                type(e).__name__, e)
        self._refresh_thread = threading.Thread(
            target=refresh_loop, name="fleet-router-refresh", daemon=True)
        self._refresh_thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=self.refresh_s * 4 + 1)
            self._refresh_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def address(self) -> str:
        return f"http://{self.bind_address}:{self.port}"


def _err(code: int, reason: str, message: str,
         retry_after_s: Optional[float] = None) -> _Upstream:
    headers = {"Content-Type": "application/json"}
    if retry_after_s is not None:
        headers["Retry-After"] = str(max(1, math.ceil(retry_after_s)))
    return _Upstream(code, headers,
                     json.dumps({"error": message,
                                 "reason": reason}).encode())


def _parse_target(path: str) -> Optional[Tuple[str, str]]:
    for prefix, kind in (("/v1/models/", "model"),
                         ("/v1/indexes/", "index")):
        if path.startswith(prefix):
            name = path[len(prefix):].split(":", 1)[0]
            if name and "/" not in name:
                return kind, name
    return None


class _RouterHandler(BaseHTTPRequestHandler):
    router_ref: Optional[FleetRouter] = None
    timeout = 30.0  # slow-client guard, same as the serving tier

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, up: _Upstream):
        self.send_response(up.status)
        for k, v in up.headers.items():
            self.send_header(k, v)
        if "Content-Type" not in up.headers:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(up.body)))
        self.end_headers()
        try:
            self.wfile.write(up.body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _json(self, obj, code: int = 200):
        self._reply(_Upstream(code, {"Content-Type": "application/json"},
                              json.dumps(obj).encode()))

    # ----------------------------------------------------------------- GET
    def do_GET(self):
        rt = type(self).router_ref
        path = urlparse(self.path).path
        if path == "/healthz":
            table = rt.table()
            self._json({"ok": True, "ready_replicas": len(table)})
        elif path == "/readyz":
            table = rt.table()
            if table:
                self._json({"ready": True, "replicas": sorted(table)})
            else:
                self._json({"ready": False,
                            "reasons": ["no ready replica"]}, 503)
        elif path == "/metrics":
            from deeplearning4j_tpu_torch.obs.exporters import prometheus_text
            self._reply(_Upstream(
                200,
                {"Content-Type":
                 "text/plain; version=0.0.4; charset=utf-8"},
                prometheus_text().encode()))
        elif path == "/v1/fleet":
            self._json(rt.view.snapshot())
        elif path in ("/v1/models", "/v1/indexes"):
            key = "models" if path == "/v1/models" else "indexes"
            table = rt.table()
            names = sorted({n for r in table.values()
                            for n in getattr(r, key)})
            self._json({key: names,
                        "placement": {n: sorted(
                            r.replica_id for r in table.values()
                            if n in getattr(r, key)) for n in names}})
        else:
            target = _parse_target(path)
            if target is None:
                self._reply(_err(404, "not_found", "not found"))
                return
            rt._m_requests.inc()
            t0 = time.monotonic()
            up = rt._forward(target[0], target[1], "GET", path, None,
                             None, idempotent=True)
            rt._m_request_ms.observe((time.monotonic() - t0) * 1e3)
            self._reply(up)

    # ---------------------------------------------------------------- POST
    def do_POST(self):
        rt = type(self).router_ref
        path = urlparse(self.path).path
        target = _parse_target(path)
        is_predict = path.endswith(":predict") or path.endswith(":query")
        if target is None or not is_predict:
            self._reply(_err(404, "not_found", "not found"))
            return
        rt._m_requests.inc()
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._reply(_err(400, "bad_request", "bad Content-Length"))
            return
        if length > rt.max_body_bytes:
            self._reply(_err(413, "body_too_large",
                             f"body {length} bytes exceeds "
                             f"{rt.max_body_bytes}"))
            return
        try:
            body = self.rfile.read(length) if length else b""
        except Exception:
            return  # client died mid-send; nothing to answer
        t0 = time.monotonic()
        # predict/query are pure reads over immutable-per-swap serving
        # graphs: idempotent, so mid-stream transport failures may retry
        # against a different replica
        up = rt._forward(target[0], target[1], "POST", path, body,
                         self.headers.get("Content-Type"),
                         idempotent=True)
        rt._m_request_ms.observe((time.monotonic() - t0) * 1e3)
        self._reply(up)
