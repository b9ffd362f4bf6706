"""Nearest-neighbors HTTP server.

Parity surface: reference
``deeplearning4j-nearestneighbor-server/.../NearestNeighborsServer.java:44``
(serve k-NN queries over a VPTree built from a points file; POST /knn with a
vector + k, JSON results; /knnnew for vectors not in the index).

stdlib ThreadingHTTPServer like the UI server (the reference uses Play).

Wire format: both routes speak JSON, and additionally the serving tier's
binary payloads (serving/wire.py). ``/knnnew`` accepts the query
vector(s) as ``{"x_b64", "dtype", "shape"}`` — float32/float64, or int8
with an explicit ``"scale"`` (this host server has no calibrated grid to
fall back on) — including a BATCH of queries (shape ``(b, d)``), which
answers one result list per row. Any request with ``"b64": true`` gets
the result matrix back as ``indices_b64``/``distances_b64`` (int32/
float32 little-endian) instead of JSON floats — bulk query batches stop
paying the JSON float bloat (~3x, and ~12x for int8 queries). Parity
with the JSON path is bit-exact and tier-1-tested.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.utils.http import parse_content_length


class _Handler(BaseHTTPRequestHandler):
    server_ref = None  # type: Optional["NearestNeighborsServer"]

    def log_message(self, fmt, *args):
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        """Size-capped body read (utils/http.py contract: a
        missing/invalid Content-Length is a structured 400, an oversized
        one a structured 413, both answered BEFORE reading the payload).
        Returns None after answering the error."""
        srv = type(self).server_ref
        length, err = parse_content_length(self.headers,
                                           srv.max_body_bytes)
        if err is not None:
            code, message = err
            self._json({"error": message}, code)
            return None
        return self.rfile.read(length)

    def do_GET(self):
        srv = type(self).server_ref
        if self.path in ("/status", "/"):
            self._json({"ok": True, "num_points": len(srv.points),
                        "dims": int(srv.points.shape[1])})
        else:
            self._json({"error": "not found"}, 404)

    def _result_payload(self, srv, rows, b64: bool, batched: bool):
        """rows: list of (indices, distances) per query row. JSON mode
        answers the reference result-object lists; b64 mode answers the
        packed int32/float32 matrices (identical numbers, ~3x fewer
        bytes — the serving/wire.py contract)."""
        if b64:
            from deeplearning4j_tpu_torch.serving.wire import encode_array
            idx = np.asarray([r[0] for r in rows], np.int32)
            dist = np.asarray([r[1] for r in rows], np.float32)
            if not batched:
                idx, dist = idx[0], dist[0]
            return {
                "indices_b64": encode_array(idx, "indices_b64")["indices_b64"],
                "distances_b64": encode_array(
                    dist, "distances_b64")["distances_b64"],
                "shape": list(idx.shape),
            }
        def one(pairs):
            return [{"index": int(i), "distance": float(d),
                     **({"label": srv.labels[i]} if srv.labels else {})}
                    for i, d in pairs]
        if batched:
            return {"batch_results": [one(zip(*r)) for r in rows]}
        return {"results": one(zip(*rows[0]))}

    def do_POST(self):
        srv = type(self).server_ref
        raw = self._read_body()
        if raw is None:
            return
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                self._json({"error": "request body must be a JSON object"},
                           400)
                return
            k = int(req.get("k", 1))
            if k < 1:
                self._json({"error": f"k must be >= 1; got {k}"}, 400)
                return
            if self.path == "/knn":
                # query by index of an existing point (reference /knn contract)
                idx = int(req.get("index", -1))
                if not 0 <= idx < len(srv.points):
                    self._json({"error": f"index {idx} out of range"}, 400)
                    return
                indices, dists = srv.tree.search(srv.points[idx], k + 1)
                pairs = [(i, d) for i, d in zip(indices, dists)
                         if i != idx][:k]
                rows, batched = [tuple(zip(*pairs)) if pairs
                                 else ((), ())], False
            elif self.path == "/knnnew":
                if "x_b64" in req:
                    # binary wire form (serving/wire.py); int8 needs an
                    # explicit "scale" — no calibrated grid on this server
                    from deeplearning4j_tpu_torch.serving.wire import decode_array
                    vec = decode_array(
                        req, int8_hint="int8 query payloads need a "
                        "'scale' field on this server; send float32"
                    ).astype(np.float64)
                else:
                    vec = np.asarray(req.get("ndarray", req.get("vector")),
                                     np.float64)
                batched = vec.ndim == 2
                if (vec.ndim not in (1, 2)
                        or vec.shape[-1] != srv.points.shape[1]):
                    self._json({"error": "vector dims mismatch"}, 400)
                    return
                rows = [srv.tree.search(v, k)
                        for v in (vec if batched else [vec])]
            else:
                self._json({"error": "not found"}, 404)
                return
            payload = self._result_payload(srv, rows, bool(req.get("b64")),
                                           batched)
        except Exception as e:  # malformed request -> 400, never a dead thread
            self._json({"error": f"bad request: {e}"}, 400)
            return
        self._json(payload)


class NearestNeighborsServer:
    """``NearestNeighborsServer(points).start(port)`` then POST /knn or
    /knnnew (see module docstring)."""

    def __init__(self, points, labels: Optional[Sequence[str]] = None,
                 distance: str = "euclidean", max_body_bytes: int = 1 << 20):
        self.points = np.asarray(points, np.float64)
        if labels is not None and len(labels) != len(self.points):
            raise ValueError("labels length must match points")
        self.labels = list(labels) if labels is not None else None
        self.tree = VPTree(self.points, distance=distance)
        # a k-NN query is one vector: anything beyond ~1MB is abuse, and
        # an uncapped read lets one POST grow server memory arbitrarily
        self.max_body_bytes = int(max_body_bytes)
        self._httpd: Optional[ThreadingHTTPServer] = None

    def start(self, port: int = 9200,
              bind_address: str = "127.0.0.1") -> "NearestNeighborsServer":
        # loopback by default; pass bind_address="0.0.0.0" to serve remotely
        handler = type("BoundNNHandler", (_Handler,), {"server_ref": self})
        self._httpd = ThreadingHTTPServer((bind_address, port), handler)
        self.port = self._httpd.server_address[1]
        # a short poll interval: stop() returns within 50 ms, not 0.5 s
        threading.Thread(target=self._httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True).start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
