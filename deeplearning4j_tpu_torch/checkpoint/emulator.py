"""A hermetic, fault-injecting object-store emulator — the HTTP-level
successor to :class:`~deeplearning4j_tpu_torch.checkpoint.faults.FlakyBackend`.

One stdlib :class:`ThreadingHTTPServer` (the serving house style) speaking
the same S3-dialect REST that :class:`CloudObjectBackend` emits: object
GET/PUT/HEAD/DELETE, ``list-type=2`` paging with continuation tokens, the
full multipart protocol (initiate/part/complete/abort + in-flight upload
listing), and DLT4 signature verification when credentials are configured.
Objects live in an in-process dict, so every chaos test runs with zero
external services — but the failure surface is the REAL one: sockets,
status codes, headers, half-sent bodies.

Faults are scripted exactly like FlakyBackend's, aimable at a logical op
and a key prefix, consumed one request each:

- ``script("latency", seconds=0.2)``        — stall, then answer normally;
- ``script("status", code=429, retry_after=0.05)`` — error burst with an
  optional ``Retry-After`` header (503s the same way);
- ``script("disconnect")``                  — declare the full
  Content-Length, send half the body, close the socket (mid-transfer
  disconnect → the client's short-body transient);
- ``script("bitrot")``                      — serve the body with one byte
  flipped (transport-level rot; :meth:`flip_byte` rots at REST instead).

A torn multipart upload is composed from primitives: script a ``status``
fault on op ``"complete"`` (and optionally on ``"abort"``) — the client
must abort, and a reader must never observe the partial object;
``clean_orphans`` reaps whatever an aborted abort leaves behind.

Ops for targeting: ``get put list exists delete initiate part complete
abort mpu-list``. ``transient_rate`` adds FlakyBackend-style seeded
probabilistic 503s on top of scripted faults.
"""

from __future__ import annotations

import hashlib
import logging
import random
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.checkpoint.cloud import SIGNING_SCHEME, sign_request
from deeplearning4j_tpu_torch.utils.http import parse_content_length

log = logging.getLogger(__name__)

__all__ = ["ObjectStoreEmulator"]

_FAULT_KINDS = ("latency", "status", "disconnect", "bitrot")


class _Handler(BaseHTTPRequestHandler):
    server_ref: "ObjectStoreEmulator" = None  # bound per-emulator below
    protocol_version = "HTTP/1.1"
    timeout = 30  # a wedged client costs one handler thread for 30s, max

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("emulator: " + fmt, *args)

    # --------------------------------------------------------- dispatch
    def do_GET(self):
        self.server_ref.handle(self, "GET")

    def do_PUT(self):
        self.server_ref.handle(self, "PUT")

    def do_POST(self):
        self.server_ref.handle(self, "POST")

    def do_DELETE(self):
        self.server_ref.handle(self, "DELETE")

    def do_HEAD(self):
        self.server_ref.handle(self, "HEAD")


class ObjectStoreEmulator:
    """See module docstring. ``start()`` binds (port 0 = auto), ``.url``
    is the endpoint for :class:`CloudObjectBackend`; use as a context
    manager in tests. ``require_auth`` defaults on when both keys are
    given."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 require_auth: Optional[bool] = None,
                 max_body_bytes: int = 256 << 20,
                 transient_rate: float = 0.0,
                 seed: Optional[int] = None):
        self.host = host
        self.port = int(port)
        self.access_key = access_key
        self.secret_key = secret_key
        self.require_auth = (bool(access_key and secret_key)
                             if require_auth is None else bool(require_auth))
        self.max_body_bytes = int(max_body_bytes)
        self.transient_rate = float(transient_rate)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.objects: Dict[str, Dict[str, bytes]] = {}   # bucket -> key -> b
        self._uploads: Dict[Tuple[str, str], Dict[int, bytes]] = {}
        self._upload_keys: Dict[str, str] = {}           # upload_id -> key
        self._upload_seq = 0
        self._scripts: List[dict] = []
        self.calls: Dict[str, int] = {}
        self.faults_injected = 0
        self.auth_rejections = 0
        self.pages_served = 0
        self.parts_received = 0
        self.completes = 0
        self.aborts = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ObjectStoreEmulator":
        handler = type("BoundEmulatorHandler", (_Handler,),
                       {"server_ref": self})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        # a short poll interval: stop() returns within 50 ms, not 0.5 s
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        name="object-store-emulator",
                                        daemon=True)
        self._thread.start()
        log.info("object-store emulator listening on %s", self.url)
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ObjectStoreEmulator":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def bucket_url(self, bucket: str) -> str:
        return f"{self.url}/{bucket}"

    # ------------------------------------------------------ fault scripting
    def script(self, kind: str, n: int = 1, *, op: Optional[str] = None,
               match: Optional[str] = None, code: int = 503,
               retry_after: Optional[float] = None, seconds: float = 0.1):
        """Queue ``n`` one-shot faults of ``kind`` (see module docstring),
        optionally aimed at a logical ``op`` and/or a key prefix
        ``match`` — FlakyBackend's ``script_failures`` at the HTTP level."""
        if kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"one of {_FAULT_KINDS}")
        with self._lock:
            for _ in range(max(0, int(n))):
                self._scripts.append({"kind": kind, "op": op,
                                      "match": match, "code": int(code),
                                      "retry_after": retry_after,
                                      "seconds": float(seconds)})

    def clear_scripts(self):
        with self._lock:
            self._scripts.clear()

    def _take_fault(self, op: str, key: str) -> Optional[dict]:
        with self._lock:
            for i, f in enumerate(self._scripts):
                if f["op"] is not None and f["op"] != op:
                    continue
                if f["match"] is not None and not key.startswith(f["match"]):
                    continue
                self.faults_injected += 1
                return self._scripts.pop(i)
            if self.transient_rate > 0 and \
                    self._rng.random() < self.transient_rate:
                self.faults_injected += 1
                return {"kind": "status", "code": 503, "retry_after": None}
        return None

    # ------------------------------------------------------ chaos utilities
    def flip_byte(self, bucket: str, key: str, offset: int = 0):
        """Bit-rot AT REST: flip one byte of the committed object — every
        subsequent read serves the rotted bytes (vs the one-shot transport
        rot of ``script("bitrot")``)."""
        with self._lock:
            data = bytearray(self.objects[bucket][key])
            data[offset % max(1, len(data))] ^= 0xFF
            self.objects[bucket][key] = bytes(data)

    def in_flight_uploads(self) -> List[Tuple[str, str]]:
        """[(bucket/key, upload_id)] of sessions not yet completed or
        aborted — what clean_orphans should reap."""
        with self._lock:
            return [(f"{b}/{k}", uid)
                    for (b, uid), _ in self._uploads.items()
                    for k in [self._upload_keys[uid]]]

    # ------------------------------------------------------------- request
    def handle(self, h: _Handler, method: str):
        try:
            self._handle(h, method)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-reply — its problem, not ours
        except Exception as e:  # a handler crash must not kill the server
            log.warning("emulator handler error (%s: %s)",
                        type(e).__name__, e)
            try:
                self._error(h, 500, f"InternalError: {e}")
            except OSError:
                pass  # socket already gone; the warning above recorded it

    def _handle(self, h: _Handler, method: str):
        raw_path, _, raw_query = h.path.partition("?")
        query = urllib.parse.parse_qs(raw_query, keep_blank_values=True)
        segments = [s for s in raw_path.split("/") if s]
        bucket = urllib.parse.unquote(segments[0]) if segments else ""
        key = urllib.parse.unquote("/".join(segments[1:])) \
            if len(segments) > 1 else ""

        body = b""
        if method in ("PUT", "POST"):
            length, err = parse_content_length(h.headers,
                                               self.max_body_bytes)
            if err is not None:
                return self._error(h, err[0], err[1])
            body = h.rfile.read(length)
            if len(body) != length:
                return  # client died mid-send; nothing to answer
        op = self._logical_op(method, key, query)
        with self._lock:
            self.calls[op] = self.calls.get(op, 0) + 1

        declared_sha = h.headers.get("x-dlt-content-sha256")
        if declared_sha is not None and method in ("PUT", "POST") and \
                hashlib.sha256(body).hexdigest() != declared_sha:
            # per-part / per-object integrity: a payload corrupted in
            # flight is rejected at upload time, not found at restore
            return self._error(h, 400, "BadDigest")
        if not self._check_auth(h, method, raw_path, raw_query,
                                declared_sha):
            return self._error(h, 403, "SignatureDoesNotMatch")

        fault = self._take_fault(op, key)
        if fault is not None:
            if fault["kind"] == "latency":
                time.sleep(fault["seconds"])
            elif fault["kind"] == "status":
                extra = {}
                if fault.get("retry_after") is not None:
                    extra["Retry-After"] = f"{fault['retry_after']:g}"
                return self._error(h, fault["code"],
                                   "scripted fault", extra)
            # disconnect/bitrot apply at send time, below
        tear = fault is not None and fault["kind"] == "disconnect"
        rot = fault is not None and fault["kind"] == "bitrot"

        if op == "list":
            return self._do_list(h, bucket, query)
        if op == "mpu-list":
            return self._do_mpu_list(h, bucket)
        if op == "initiate":
            return self._do_initiate(h, bucket, key)
        if op == "part":
            return self._do_part(h, bucket, key, query, body)
        if op == "complete":
            return self._do_complete(h, bucket, key, query, body)
        if op == "abort":
            return self._do_abort(h, query)
        if op == "put":
            return self._do_put(h, bucket, key, body)
        if op == "get":
            return self._do_get(h, bucket, key, tear=tear, rot=rot)
        if op == "exists":
            return self._do_head(h, bucket, key)
        if op == "delete":
            return self._do_delete(h, bucket, key)
        return self._error(h, 400, f"unsupported request {method} {h.path}")

    @staticmethod
    def _logical_op(method: str, key: str, query: Dict[str, list]) -> str:
        if method == "GET":
            if not key:
                return "mpu-list" if "uploads" in query else "list"
            return "get"
        if method == "PUT":
            return "part" if "uploadId" in query else "put"
        if method == "POST":
            if "uploads" in query:
                return "initiate"
            if "uploadId" in query:
                return "complete"
            return "post"
        if method == "DELETE":
            return "abort" if "uploadId" in query else "delete"
        if method == "HEAD":
            return "exists"
        return method.lower()

    def _check_auth(self, h: _Handler, method: str, path: str, query: str,
                    declared_sha: Optional[str]) -> bool:
        """Verify the DLT4 signature with the SAME code the client signs
        with (cloud.sign_request) — drift between signer and verifier is
        structurally impossible."""
        if not self.require_auth:
            return True
        auth = h.headers.get("Authorization", "")
        date = h.headers.get("x-dlt-date", "")
        ok = False
        if auth.startswith(SIGNING_SCHEME + " ") and declared_sha and date:
            fields = dict(
                part.strip().split("=", 1)
                for part in auth[len(SIGNING_SCHEME):].split(",")
                if "=" in part)
            cred = fields.get("Credential", "")
            sig = fields.get("Signature", "")
            expect = sign_request(self.secret_key, method, path, query,
                                  date, declared_sha)
            ok = (cred.split("/")[0] == self.access_key
                  and hmac_compare(sig, expect))
        if not ok:
            with self._lock:
                self.auth_rejections += 1
        return ok

    # -------------------------------------------------------------- ops
    def _do_put(self, h: _Handler, bucket: str, key: str, body: bytes):
        with self._lock:
            self.objects.setdefault(bucket, {})[key] = body
        self._reply(h, 200, b"")

    def _do_get(self, h: _Handler, bucket: str, key: str, *,
                tear: bool = False, rot: bool = False):
        with self._lock:
            data = self.objects.get(bucket, {}).get(key)
        if data is None:
            return self._error(h, 404, f"NoSuchKey: {bucket}/{key}")
        if rot and data:
            rotten = bytearray(data)
            rotten[len(rotten) // 2] ^= 0xFF
            data = bytes(rotten)
        if tear:
            # declare everything, deliver half, hang up: the mid-transfer
            # disconnect CloudObjectBackend must classify as transient
            h.send_response(200)
            h.send_header("Content-Length", str(len(data)))
            h.end_headers()
            h.wfile.write(data[:len(data) // 2])
            h.wfile.flush()
            h.close_connection = True
            try:
                h.connection.close()
            except OSError:
                pass
            return
        self._reply(h, 200, data,
                    {"x-dlt-content-sha256":
                     hashlib.sha256(data).hexdigest()})

    def _do_head(self, h: _Handler, bucket: str, key: str):
        with self._lock:
            data = self.objects.get(bucket, {}).get(key)
        if data is None:
            return self._error(h, 404, "NoSuchKey", head=True)
        h.send_response(200)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()

    def _do_delete(self, h: _Handler, bucket: str, key: str):
        with self._lock:
            self.objects.get(bucket, {}).pop(key, None)
        self._reply(h, 204, b"")

    def _do_list(self, h: _Handler, bucket: str, query: Dict[str, list]):
        prefix = query.get("prefix", [""])[0]
        max_keys = max(1, int(query.get("max-keys", ["1000"])[0]))
        token = query.get("continuation-token", [None])[0]
        with self._lock:
            keys = sorted(k for k in self.objects.get(bucket, {})
                          if k.startswith(prefix))
            self.pages_served += 1
        if token:
            keys = [k for k in keys if k > token]
        page, rest = keys[:max_keys], keys[max_keys:]
        truncated = bool(rest)
        parts = ["<?xml version='1.0'?><ListBucketResult>",
                 f"<IsTruncated>{'true' if truncated else 'false'}"
                 f"</IsTruncated>"]
        if truncated:
            parts.append(f"<NextContinuationToken>{_xml_escape(page[-1])}"
                         f"</NextContinuationToken>")
        parts.extend(f"<Contents><Key>{_xml_escape(k)}</Key></Contents>"
                     for k in page)
        parts.append("</ListBucketResult>")
        self._reply(h, 200, "".join(parts).encode(),
                    {"Content-Type": "application/xml"})

    def _do_initiate(self, h: _Handler, bucket: str, key: str):
        with self._lock:
            self._upload_seq += 1
            upload_id = f"mpu-{self._upload_seq:08d}"
            self._uploads[(bucket, upload_id)] = {}
            self._upload_keys[upload_id] = key
        body = (f"<?xml version='1.0'?><InitiateMultipartUploadResult>"
                f"<Bucket>{_xml_escape(bucket)}</Bucket>"
                f"<Key>{_xml_escape(key)}</Key>"
                f"<UploadId>{upload_id}</UploadId>"
                f"</InitiateMultipartUploadResult>").encode()
        self._reply(h, 200, body, {"Content-Type": "application/xml"})

    def _do_part(self, h: _Handler, bucket: str, key: str,
                 query: Dict[str, list], body: bytes):
        upload_id = query.get("uploadId", [""])[0]
        try:
            number = int(query.get("partNumber", [""])[0])
        except ValueError:
            return self._error(h, 400, "InvalidPartNumber")
        with self._lock:
            session = self._uploads.get((bucket, upload_id))
            if session is None:
                return self._error(h, 404, f"NoSuchUpload: {upload_id}")
            session[number] = body
            self.parts_received += 1
        self._reply(h, 200, b"",
                    {"ETag": hashlib.sha256(body).hexdigest()})

    def _do_complete(self, h: _Handler, bucket: str, key: str,
                     query: Dict[str, list], body: bytes):
        upload_id = query.get("uploadId", [""])[0]
        with self._lock:
            session = self._uploads.get((bucket, upload_id))
            if session is None:
                return self._error(h, 404, f"NoSuchUpload: {upload_id}")
            numbers = sorted(session)
            if not numbers or numbers != list(range(1, numbers[-1] + 1)):
                return self._error(h, 400, "InvalidPart: gap in parts")
            # the atomic commit point: assembled object appears all at
            # once; the session disappears with it
            assembled = b"".join(session[n] for n in numbers)
            self.objects.setdefault(bucket, {})[key] = assembled
            del self._uploads[(bucket, upload_id)]
            del self._upload_keys[upload_id]
            self.completes += 1
        reply = (f"<?xml version='1.0'?><CompleteMultipartUploadResult>"
                 f"<Key>{_xml_escape(key)}</Key>"
                 f"</CompleteMultipartUploadResult>").encode()
        self._reply(h, 200, reply, {"Content-Type": "application/xml"})

    def _do_abort(self, h: _Handler, query: Dict[str, list]):
        upload_id = query.get("uploadId", [""])[0]
        with self._lock:
            key = self._upload_keys.pop(upload_id, None)
            removed = False
            for (b, uid) in list(self._uploads):
                if uid == upload_id:
                    del self._uploads[(b, uid)]
                    removed = True
            if removed:
                self.aborts += 1
        self._reply(h, 204 if removed or key else 404, b"")

    def _do_mpu_list(self, h: _Handler, bucket: str):
        with self._lock:
            ups = [(self._upload_keys[uid], uid)
                   for (b, uid) in self._uploads if b == bucket]
        parts = ["<?xml version='1.0'?><ListMultipartUploadsResult>"]
        parts.extend(f"<Upload><Key>{_xml_escape(k)}</Key>"
                     f"<UploadId>{uid}</UploadId></Upload>"
                     for k, uid in sorted(ups))
        parts.append("</ListMultipartUploadsResult>")
        self._reply(h, 200, "".join(parts).encode(),
                    {"Content-Type": "application/xml"})

    # ------------------------------------------------------------- replies
    def _reply(self, h: _Handler, code: int, body: bytes,
               headers: Optional[Dict[str, str]] = None):
        h.send_response(code)
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        if body:
            h.wfile.write(body)

    def _error(self, h: _Handler, code: int, message: str,
               headers: Optional[Dict[str, str]] = None,
               head: bool = False):
        body = b"" if head else (f"<?xml version='1.0'?><Error>"
                                 f"<Message>{_xml_escape(message)}"
                                 f"</Message></Error>").encode()
        self._reply(h, code, body, headers)


def hmac_compare(a: str, b: str) -> bool:
    import hmac as _hmac
    return _hmac.compare_digest(a.encode(), b.encode())


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))
