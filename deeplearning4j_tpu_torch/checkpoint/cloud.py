"""CloudObjectBackend — a real wire-protocol object-store client behind
the five-method :class:`~deeplearning4j_tpu_torch.checkpoint.storage.StorageBackend`
surface (counterpart of ``deeplearning4j_tpu/checkpoint/cloud.py``: the
same requests, signatures and replies, so either package's client talks to
either package's emulator).

Speaks the S3-style REST dialect over stdlib ``http.client`` (no SDK
dependency): GET/PUT/HEAD/DELETE on ``/{bucket}/{key}``, ``list-type=2``
paged listing with continuation tokens, and the multipart-upload protocol
(initiate → per-part PUT with sha256 → complete/abort) for objects above a
size threshold. Everything durable in the port — manifests, sharded
checkpoints, shard leases, the flight recorder — already speaks
StorageBackend, so pointing any of it at a bucket is a constructor swap.

Design rules (each is load-bearing):

- **Taxonomy mapping.** HTTP status → the existing error taxonomy so
  :class:`RetryingBackend` and the manager's fallback logic work unchanged
  over the wire: 404 → :class:`StorageNotFoundError`; 400/403 (and other
  4xx) → :class:`PermanentStorageError` — retrying a bad request or bad
  credentials only delays the real error; 408/429/5xx and every
  connection-level fault (refused, reset, timeout, short body) →
  :class:`TransientStorageError`. A 429/503 ``Retry-After`` header is
  parsed onto the error's ``retry_after_s`` so RetryingBackend can honor
  the server's own schedule (capped at its backoff ceiling).
- **Bounded I/O.** Every socket operation carries ``timeout=`` and every
  response read is byte-bounded: a hostile or wedged server costs one deadline, not a hung
  training run or unbounded memory.
- **Atomic puts.** A single-shot put is one request; a multipart put is
  invisible until the final ``complete`` — parts live outside the object
  namespace and any failure triggers an abort, so readers NEVER observe a
  torn upload. Each part carries its sha256 so a corrupted part is
  rejected at upload time (400), not discovered at restore.
- **Signing stub point.** Requests are signed with a V4-shaped
  HMAC-SHA256 scheme (``DLT4-HMAC-SHA256``) over a canonical
  method/path/query/date/payload-sha string. :meth:`_signature` is the
  single seam where a production AWS SigV4 implementation slots in; the
  emulator verifies this scheme end to end. Credentials resolve
  explicit args → environment → credentials file → anonymous.

Integrity stays where it already lives: the manifest layer's
sha256-per-entry detects bit-rot through this backend exactly as it does
locally, and restore falls back past it (checkpoint/emulator.py scripts
the faults over the wire).
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import logging
import os
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.checkpoint.storage import (
    LocalFSBackend,
    ObjectStoreBackend,
    PermanentStorageError,
    RetryingBackend,
    StorageBackend,
    StorageNotFoundError,
    TransientStorageError,
    sweep_orphan_keys,
)

log = logging.getLogger(__name__)

__all__ = ["CloudObjectBackend", "CloudCredentials", "backend_from_url",
           "SIGNING_SCHEME"]

SIGNING_SCHEME = "DLT4-HMAC-SHA256"

# Environment variables consulted for credentials, in order; the AWS pair
# is accepted so an existing environment works unmodified.
_ENV_KEYS = (("DLT_LAKE_ACCESS_KEY_ID", "DLT_LAKE_SECRET_ACCESS_KEY"),
             ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"))
_ENV_CREDENTIALS_FILE = "DLT_LAKE_SHARED_CREDENTIALS_FILE"

_CHUNK = 1 << 20  # socket read granularity; bounds below cap totals


class CloudCredentials:
    """A resolved (access_key, secret_key) pair, or anonymous.

    Resolution order — first hit wins:

    1. explicit ``access_key``/``secret_key`` arguments;
    2. environment: ``DLT_LAKE_ACCESS_KEY_ID``/``DLT_LAKE_SECRET_ACCESS_KEY``
       then ``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``;
    3. a credentials file (``credentials_file`` argument or
       ``$DLT_LAKE_SHARED_CREDENTIALS_FILE``): ``key = value`` lines,
       ``#`` comments and ``[section]`` headers ignored, keys
       ``access_key_id``/``secret_access_key`` (an AWS-style shared
       credentials file parses as-is);
    4. anonymous (requests go unsigned).
    """

    def __init__(self, access_key: Optional[str] = None,
                 secret_key: Optional[str] = None):
        self.access_key = access_key
        self.secret_key = secret_key

    @property
    def anonymous(self) -> bool:
        return self.access_key is None or self.secret_key is None

    @classmethod
    def resolve(cls, access_key: Optional[str] = None,
                secret_key: Optional[str] = None,
                credentials_file: Optional[str] = None,
                env: Optional[Dict[str, str]] = None) -> "CloudCredentials":
        env = os.environ if env is None else env
        if access_key and secret_key:
            return cls(access_key, secret_key)
        for ak_var, sk_var in _ENV_KEYS:
            ak, sk = env.get(ak_var), env.get(sk_var)
            if ak and sk:
                return cls(ak, sk)
        path = credentials_file or env.get(_ENV_CREDENTIALS_FILE)
        if path and os.path.isfile(path):
            fields: Dict[str, str] = {}
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith(("#", ";", "[")):
                        continue
                    if "=" in line:
                        k, _, v = line.partition("=")
                        fields[k.strip().lower()] = v.strip()
            ak = fields.get("access_key_id") or fields.get(
                "aws_access_key_id")
            sk = fields.get("secret_access_key") or fields.get(
                "aws_secret_access_key")
            if ak and sk:
                return cls(ak, sk)
        return cls()


def sign_request(secret_key: str, method: str, path: str, query: str,
                 date: str, payload_sha: str) -> str:
    """The DLT4 signature over the canonical request string. Module-level
    so the emulator verifies with the exact same code the client signs
    with — the two cannot drift."""
    canonical = "\n".join((method.upper(), path, query, date, payload_sha))
    return hmac.new(secret_key.encode(), canonical.encode(),
                    hashlib.sha256).hexdigest()


class CloudObjectBackend(StorageBackend):
    """S3-dialect HTTP object-store client (see module docstring).

    ``endpoint`` is ``http://host:port`` (https accepted); ``bucket`` is
    the flat namespace all five methods operate in. One fresh connection
    per request — simple, stateless, and immune to a poisoned keep-alive
    socket after a mid-body disconnect.

    Knobs: ``timeout_s`` bounds EVERY socket operation (connect, send,
    recv); ``multipart_threshold`` and ``part_size`` shape large puts;
    ``max_object_bytes`` caps any single response body;
    ``list_page_size`` is the server-side page size (``max-keys``).
    """

    def __init__(self, endpoint: str, bucket: str = "checkpoints", *,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 credentials_file: Optional[str] = None,
                 timeout_s: float = 10.0,
                 multipart_threshold: int = 8 << 20,
                 part_size: int = 5 << 20,
                 max_object_bytes: int = 1 << 31,
                 list_page_size: int = 1000):
        parsed = urllib.parse.urlsplit(endpoint)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"endpoint must be http(s)://host:port, "
                             f"got {endpoint!r}")
        if not parsed.hostname:
            raise ValueError(f"endpoint has no host: {endpoint!r}")
        if part_size <= 0 or multipart_threshold <= 0:
            raise ValueError("part_size and multipart_threshold must be > 0")
        self.scheme = parsed.scheme
        self.host = parsed.hostname
        self.port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self.bucket = bucket
        self.credentials = CloudCredentials.resolve(
            access_key, secret_key, credentials_file)
        self.timeout_s = float(timeout_s)
        self.multipart_threshold = int(multipart_threshold)
        self.part_size = int(part_size)
        self.max_object_bytes = int(max_object_bytes)
        self.list_page_size = int(list_page_size)
        self.op_counts: Dict[str, int] = {}
        self.requests_sent = 0
        self.multipart_puts = 0
        self.multipart_aborts = 0
        self.uploads_aborted = 0  # clean_orphans: abandoned uploads reaped

    # ------------------------------------------------------------ plumbing
    def _count(self, op: str):
        self.op_counts[op] = self.op_counts.get(op, 0) + 1

    def _path(self, key: Optional[str] = None) -> str:
        base = "/" + urllib.parse.quote(self.bucket, safe="")
        if key is None:
            return base
        return base + "/" + urllib.parse.quote(key, safe="/-_.~")

    def _headers(self, method: str, path: str, query: str,
                 body: bytes) -> Dict[str, str]:
        payload_sha = hashlib.sha256(body).hexdigest()
        date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        headers = {"Host": f"{self.host}:{self.port}",
                   "x-dlt-date": date,
                   "x-dlt-content-sha256": payload_sha,
                   "Content-Length": str(len(body))}
        if not self.credentials.anonymous:
            sig = self._signature(method, path, query, date, payload_sha)
            headers["Authorization"] = (
                f"{SIGNING_SCHEME} "
                f"Credential={self.credentials.access_key}/{date[:8]}, "
                f"SignedHeaders=host;x-dlt-date;x-dlt-content-sha256, "
                f"Signature={sig}")
        return headers

    def _signature(self, method: str, path: str, query: str, date: str,
                   payload_sha: str) -> str:
        """THE signing stub point: a production SigV4 (credential scoping,
        canonical header folding, signing-key derivation chain) replaces
        this one method; everything above and below is unchanged."""
        return sign_request(self.credentials.secret_key, method, path,
                            query, date, payload_sha)

    def _request(self, op: str, method: str, path: str, query: str = "",
                 body: bytes = b"", body_limit: Optional[int] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """One signed HTTP round trip → (status, headers, bounded body).

        Connection-level faults (refused/reset/timeout/short body) raise
        :class:`TransientStorageError`; HTTP statuses are returned to the
        caller, which maps them per-op (a 404 means different things to
        ``get`` and ``exists``)."""
        url = path + ("?" + query if query else "")
        headers = self._headers(method, path, query, body)
        limit = self.max_object_bytes if body_limit is None else body_limit
        self.requests_sent += 1
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s) \
            if self.scheme == "http" else \
            http.client.HTTPSConnection(self.host, self.port,
                                        timeout=self.timeout_s)
        try:
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            status = resp.status
            resp_headers = dict(resp.getheaders())
            # a HEAD reply declares the object's length but carries no
            # body — reading against the header would misfire as a
            # mid-transfer disconnect
            data = b"" if method == "HEAD" else \
                self._read_bounded(resp, resp_headers, limit, op)
            return status, resp_headers, data
        except (http.client.HTTPException, OSError) as e:
            if isinstance(e, StorageNotFoundError):
                raise
            raise TransientStorageError(
                f"{op} {self.describe()}: connection fault "
                f"({type(e).__name__}: {e})") from e
        finally:
            conn.close()

    @staticmethod
    def _read_bounded(resp, headers: Dict[str, str], limit: int,
                      op: str) -> bytes:
        """Read a response body under an explicit byte bound. A declared
        length over the bound is a permanent fault (the object is simply
        too big for this client's budget); a body shorter than declared is
        a mid-transfer disconnect → transient."""
        declared: Optional[int] = None
        try:
            declared = int(headers.get("Content-Length", ""))
        except ValueError:
            pass
        if declared is not None and declared > limit:
            raise PermanentStorageError(
                f"{op}: response body {declared}B exceeds the "
                f"{limit}B bound")
        budget = declared if declared is not None else limit
        chunks = []
        got = 0
        while got < budget:
            chunk = resp.read(min(_CHUNK, budget - got))
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        if declared is None and resp.read(1):
            raise PermanentStorageError(
                f"{op}: unbounded response body exceeds the {limit}B bound")
        if declared is not None and got != declared:
            raise TransientStorageError(
                f"{op}: short body — got {got} of {declared} bytes "
                f"(mid-transfer disconnect)")
        return b"".join(chunks)

    @staticmethod
    def _retry_after(headers: Dict[str, str]) -> Optional[float]:
        raw = headers.get("Retry-After")
        if raw is None:
            return None
        try:
            return max(0.0, float(raw))
        except ValueError:
            return None  # HTTP-date form — fall back to our own schedule

    def _raise_for_status(self, op: str, name: str, status: int,
                          headers: Dict[str, str], body: bytes):
        where = f"{self.bucket}/{name}" if name else self.bucket
        detail = body[:200].decode("utf-8", "replace")
        if status == 404:
            raise StorageNotFoundError(f"no such object: {where}")
        if status in (408, 429) or status >= 500:
            raise TransientStorageError(
                f"{op} {where}: HTTP {status} ({detail})",
                retry_after_s=self._retry_after(headers))
        raise PermanentStorageError(f"{op} {where}: HTTP {status} ({detail})")

    # ----------------------------------------------------------- interface
    def put(self, name: str, data: bytes, fsync_directory: bool = True):
        self._count("put")
        data = bytes(data)
        if len(data) >= self.multipart_threshold:
            return self._put_multipart(name, data)
        status, headers, body = self._request(
            "put", "PUT", self._path(name), body=data, body_limit=1 << 20)
        if status not in (200, 201, 204):
            self._raise_for_status("put", name, status, headers, body)

    def _put_multipart(self, name: str, data: bytes):
        """Initiate → PUT parts (each with its sha256) → complete; ANY
        failure aborts the upload so a torn put is never visible. The
        complete is the single atomic commit point."""
        self.multipart_puts += 1
        path = self._path(name)
        status, headers, body = self._request(
            "mpu-initiate", "POST", path, query="uploads",
            body_limit=1 << 20)
        if status != 200:
            self._raise_for_status("mpu-initiate", name, status, headers,
                                   body)
        upload_id = _xml_text(body, "UploadId")
        if not upload_id:
            raise PermanentStorageError(
                f"mpu-initiate {self.bucket}/{name}: no UploadId in reply")
        try:
            etags = []
            for number, off in enumerate(range(0, len(data),
                                               self.part_size), start=1):
                part = data[off:off + self.part_size]
                q = (f"partNumber={number}&uploadId="
                     f"{urllib.parse.quote(upload_id, safe='')}")
                status, headers, body = self._request(
                    "mpu-part", "PUT", path, query=q, body=part,
                    body_limit=1 << 20)
                if status != 200:
                    self._raise_for_status("mpu-part", name, status,
                                           headers, body)
                etags.append((number,
                              headers.get("ETag",
                                          hashlib.sha256(part).hexdigest())))
            parts_xml = "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in etags)
            complete = (f"<CompleteMultipartUpload>{parts_xml}"
                        f"</CompleteMultipartUpload>").encode()
            q = f"uploadId={urllib.parse.quote(upload_id, safe='')}"
            status, headers, body = self._request(
                "mpu-complete", "POST", path, query=q, body=complete,
                body_limit=1 << 20)
            if status != 200:
                self._raise_for_status("mpu-complete", name, status,
                                       headers, body)
        except BaseException:
            self._abort_upload(name, upload_id)
            raise

    def _abort_upload(self, name: str, upload_id: str) -> bool:
        """Best-effort multipart abort; a failed abort leaves the upload
        for :meth:`clean_orphans` to reap later."""
        self.multipart_aborts += 1
        q = f"uploadId={urllib.parse.quote(upload_id, safe='')}"
        try:
            status, _, _ = self._request(
                "mpu-abort", "DELETE", self._path(name), query=q,
                body_limit=1 << 20)
            return status in (200, 204, 404)
        except Exception as e:
            log.warning("multipart abort of %s/%s upload %s failed "
                        "(%s: %s) — clean_orphans will reap it",
                        self.bucket, name, upload_id, type(e).__name__, e)
            return False

    def get(self, name: str) -> bytes:
        self._count("get")
        status, headers, body = self._request("get", "GET",
                                              self._path(name))
        if status != 200:
            self._raise_for_status("get", name, status, headers, body)
        return body

    def list(self, prefix: str = "") -> List[str]:
        self._count("list")
        names: List[str] = []
        token: Optional[str] = None
        while True:
            q = (f"list-type=2&max-keys={self.list_page_size}"
                 f"&prefix={urllib.parse.quote(prefix, safe='')}")
            if token:
                q += f"&continuation-token={urllib.parse.quote(token, safe='')}"
            status, headers, body = self._request(
                "list", "GET", self._path(), query=q, body_limit=16 << 20)
            if status != 200:
                self._raise_for_status("list", "", status, headers, body)
            page, truncated, token = _parse_list_page(body)
            names.extend(page)
            if not truncated:
                break
            if not token:
                raise PermanentStorageError(
                    "list: truncated page without a continuation token")
        return sorted(names)

    def delete(self, name: str):
        self._count("delete")
        status, headers, body = self._request(
            "delete", "DELETE", self._path(name), body_limit=1 << 20)
        if status not in (200, 204, 404):  # deleting a missing key is a no-op
            self._raise_for_status("delete", name, status, headers, body)

    def exists(self, name: str) -> bool:
        self._count("exists")
        status, headers, body = self._request(
            "exists", "HEAD", self._path(name), body_limit=1 << 20)
        if status == 200:
            return True
        if status == 404:
            return False
        self._raise_for_status("exists", name, status, headers, body)
        return False  # unreachable

    def clean_orphans(self):
        """Reap BOTH orphan classes a crash can leave in a bucket: staging
        keys under the shared ``tmp-``/``.part`` convention (same sweep as
        ObjectStoreBackend) and abandoned multipart uploads — parts from a
        writer that died between initiate and complete/abort hold storage
        but are invisible to every reader."""
        swept = sweep_orphan_keys(self)
        status, headers, body = self._request(
            "mpu-list", "GET", self._path(), query="uploads",
            body_limit=16 << 20)
        if status != 200:
            self._raise_for_status("mpu-list", "", status, headers, body)
        uploads = _parse_uploads_page(body)
        for key, upload_id in uploads:
            if self._abort_upload(key, upload_id):
                self.uploads_aborted += 1
        if uploads:
            log.info("aborted %d abandoned multipart upload(s) in %s",
                     len(uploads), self.bucket)
        return swept

    def describe(self) -> str:
        return (f"CloudObjectBackend({self.scheme}://{self.host}:"
                f"{self.port}/{self.bucket})")


# ------------------------------------------------------------ XML parsing
def _xml_text(body: bytes, tag: str) -> Optional[str]:
    try:
        root = ET.fromstring(body.decode("utf-8", "replace"))
    except ET.ParseError:
        return None
    if root.tag == tag:
        return root.text
    el = root.find(f".//{tag}")
    return el.text if el is not None else None


def _parse_list_page(body: bytes) -> Tuple[List[str], bool, Optional[str]]:
    """One ListBucketResult page → (keys, is_truncated, next_token)."""
    try:
        root = ET.fromstring(body.decode("utf-8", "replace"))
    except ET.ParseError as e:
        raise TransientStorageError(f"list: unparseable page ({e})") from e
    keys = [el.text or "" for el in root.findall(".//Contents/Key")]
    truncated = (root.findtext("IsTruncated", "false").strip().lower()
                 == "true")
    token = root.findtext("NextContinuationToken") or None
    return keys, truncated, token


def _parse_uploads_page(body: bytes) -> List[Tuple[str, str]]:
    """ListMultipartUploadsResult → [(key, upload_id), ...]."""
    try:
        root = ET.fromstring(body.decode("utf-8", "replace"))
    except ET.ParseError as e:
        raise TransientStorageError(
            f"mpu-list: unparseable reply ({e})") from e
    out = []
    for up in root.findall(".//Upload"):
        key, uid = up.findtext("Key"), up.findtext("UploadId")
        if key and uid:
            out.append((key, uid))
    return out


# ------------------------------------------------------------ URL factory
def backend_from_url(url: str, *, cache_dir: Optional[str] = None,
                     cache_bytes: int = 256 << 20,
                     retries: int = 5,
                     timeout_s: float = 10.0,
                     access_key: Optional[str] = None,
                     secret_key: Optional[str] = None) -> StorageBackend:
    """One string → a ready-to-use backend stack:

    - ``http://host:port/bucket`` (or https) →
      RetryingBackend(CloudObjectBackend), Retry-After honored;
    - ``mem:`` → a fresh in-process ObjectStoreBackend (test double);
    - ``file:/path`` or a bare path → LocalFSBackend.

    ``cache_dir`` additionally wraps the stack in a CachedBackend disk LRU
    (``cache_bytes`` budget) — cache hits never touch the wire or the
    retry layer; fills and write-throughs go through both.
    """
    inner: StorageBackend
    if url.startswith(("http://", "https://")):
        parsed = urllib.parse.urlsplit(url)
        bucket = parsed.path.strip("/")
        if not bucket or "/" in bucket:
            raise ValueError(
                f"cloud URL must be http(s)://host:port/bucket, got {url!r}")
        endpoint = f"{parsed.scheme}://{parsed.netloc}"
        cloud = CloudObjectBackend(endpoint, bucket, timeout_s=timeout_s,
                                   access_key=access_key,
                                   secret_key=secret_key)
        inner = RetryingBackend(cloud, max_retries=retries) \
            if retries > 0 else cloud
    elif url.startswith("mem:"):
        inner = ObjectStoreBackend(bucket=url[4:] or "checkpoints")
    else:
        path = url[5:] if url.startswith("file:") else url
        inner = LocalFSBackend(path)
    if cache_dir:
        from deeplearning4j_tpu_torch.checkpoint.cache import CachedBackend
        inner = CachedBackend(inner, cache_dir, max_bytes=cache_bytes)
    return inner
