"""Overload-safe HTTP model server in front of ``ParallelInference``
(counterpart of ``deeplearning4j_tpu/serving/server.py``: the same routes,
status codes and ``reason`` tags, word for word), a stdlib
``ThreadingHTTPServer``.

Robustness under overload is the design center, not an adapter detail:

- **Continuous batching** — every HTTP handler thread ``submit()``s into
  one ``ParallelInference`` per model; its worker coalesces whatever is
  queued at dispatch time into the pow2 bucket ladder. No fixed
  microbatches: cross-client requests share device batches whenever they
  overlap in the queue.
- **Admission control / load shedding** — the per-model queue is BOUNDED
  (``ParallelInference(queue_depth=...)``); over capacity the server
  answers **429 + Retry-After immediately** instead of queueing without
  limit. A burst beyond sustainable load degrades to fast rejections,
  never to unbounded memory or forever-waiting clients.
- **Deadlines** — each request carries ``deadline_ms`` (body field,
  ``X-Deadline-Ms`` header, or the endpoint default); it propagates into
  batch formation, where expired requests are evicted BEFORE device
  dispatch and answered **504** — a request never occupies a batch slot
  it cannot use.
- **Circuit breaker** — a burst of model-dispatch failures OPENS the
  per-model :class:`~deeplearning4j_tpu_torch.serving.breaker.CircuitBreaker`;
  while open the server answers **503 fast** with Retry-After, then
  half-open probes feel for recovery.
- **Graceful drain** — ``drain()`` (and ``stop()``) sheds new arrivals
  with 503 while every in-flight request completes: zero dropped, which
  also makes checkpoint hot-swap + restart under load safe end to end.
- **Readiness** — ``/readyz`` stays 503 until every endpoint's warmup
  ladder has run once on the device (kernels built and loaded, the
  allocator sized); ``/healthz`` reports process liveness.
- **Observability** — shed/expired/breaker counters, end-to-end
  ``serving_request_ms``, in-flight gauge and per-``ParallelInference``
  queue-depth/occupancy instruments all land in the obs registry,
  scrapeable at this server's own ``/metrics``.

Routes::

    GET  /healthz                     process liveness (+ drain flag)
    GET  /readyz                      200 only when warmed and not draining
    GET  /metrics                     Prometheus exposition (obs registry)
    GET  /v1/models                   model list + serving stats
    GET  /v1/models/<name>            one model's stats (pi + breaker)
    POST /v1/models/<name>:predict    {"inputs": [[...], ...],
                                       "deadline_ms": 250}  (optional)
    POST /v1/models/<name>:generate   {"prompt_ids": [...], "max_tokens":
                                       64, "stream": true}  (serving/decode)

Generate streams tokens as Server-Sent Events over chunked HTTP/1.1
(``event: token`` / ``done`` / ``error`` frames); ``stream: false``
collects the whole generation into one JSON response. Admission rides
the same taxonomy as predict — 429 when every decode session slot is
held, 503 draining/stopped, and 504 when the FIRST token misses
``deadline_ms`` (time-to-first-token). After streaming starts the
status is already 200, so a later token missing ``token_deadline_ms``
terminates the stream with a typed in-band ``error`` event instead —
a stream never silently stalls.

Predict bodies carry the tensor either as a JSON float list (``inputs``)
or as the BINARY wire format — base64-encoded little-endian raw array
bytes::

    {"x_b64": "<base64>", "dtype": "float32", "shape": [4, 784]}

which cuts the payload to about a third of the JSON float encoding.
``dtype`` is ``"float32"`` (the native serving
dtype), ``"float64"`` (accepted, downcast to f32 on decode), or ``"int8"``
— the latter on QUANTIZED endpoints only (``quant/``): the payload is
interpreted on the endpoint's calibrated input grid (``x ≈ xq *
input_scale``, the scale reported in the endpoint's stats) — another 4x
fewer bytes on the wire.

Predict responses: 200 ``{"outputs": ...}``; 400 malformed; 404 unknown
model; 413 oversized body; 429 shed (queue full); 503 breaker open or
draining; 504 deadline expired — all errors are structured JSON with an
``"error"`` message and a ``"reason"`` tag.

HTTP handler threads never touch device tensors: they decode bodies into
host numpy and hand them to the endpoint's ``ParallelInference`` worker,
``IndexEndpoint`` worker or ``DecodeEngine`` worker, the only threads that
dispatch to the card. ``compile_cache_dir=`` raises: the port has no
compiled-program cache (ROADMAP §A7).
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.parallel.inference import (DeadlineExpiredError,
                                                         ParallelInference,
                                                         QueueFullError)
from deeplearning4j_tpu_torch.serving.breaker import BreakerOpenError, CircuitBreaker
from deeplearning4j_tpu_torch.serving.decode import (DecodeEngine,
                                                     EngineStoppedError,
                                                     SessionLimitError)
from deeplearning4j_tpu_torch.serving.wire import decode_array, encode_array
from deeplearning4j_tpu_torch.utils.http import parse_content_length

log = logging.getLogger(__name__)

__all__ = ["ModelEndpoint", "GenerateEndpoint", "ModelServer",
           "BreakerOpenError", "ModelDispatchError"]


class ModelDispatchError(RuntimeError):
    """The model dispatch itself failed (counted against the breaker)."""


class ModelEndpoint:
    """One served model: a ``ParallelInference`` plus its admission,
    deadline and breaker policy. Build through
    :meth:`ModelServer.add_model` (which owns construction defaults), or
    directly around an existing ``ParallelInference``."""

    def __init__(self, name: str, pi: ParallelInference, *,
                 default_deadline_ms: float = 1000.0,
                 breaker: Optional[CircuitBreaker] = None,
                 warmup_example=None, warmup_buckets=None,
                 owns_pi: bool = False):
        if pi.inference_mode != "batched":
            raise ValueError(
                f"endpoint '{name}' needs a batched-mode ParallelInference "
                "(continuous batching is the serving contract)")
        self.name = name
        self.pi = pi
        self.default_deadline_ms = float(default_deadline_ms)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.warmup_example = warmup_example
        self.warmup_buckets = warmup_buckets
        self.owns_pi = owns_pi
        # feature-shape guard from the warmup example: a wrong-shaped
        # request is a CLIENT error (400) and must never reach dispatch,
        # where its failure would count against the model's breaker
        self.feature_shape = (None if warmup_example is None
                              else tuple(np.asarray(warmup_example).shape[1:]))
        # warmed==True means /readyz may pass: either the ladder ran
        # or no example was given (the caller accepts a cold first request)
        self.warmed = warmup_example is None
        self._warmup_lock = threading.Lock()
        # quantized serving (quant/): the flag is surfaced per endpoint in
        # stats(), and input_scale is the calibrated grid int8 wire
        # payloads are decoded on (None ⇒ int8 payloads rejected 400)
        from deeplearning4j_tpu_torch.quant.lowering import (input_quant_scale,
                                                             is_quantized)
        self.quantized = is_quantized(pi.model)
        self.input_scale = input_quant_scale(pi.model)

    def warmup(self):
        """Dispatch the bucket ladder once; flips the readiness gate."""
        with self._warmup_lock:
            if self.warmup_example is not None:
                self.pi.warmup(self.warmup_example,
                               buckets=self.warmup_buckets)
            self.warmed = True
        return self

    def predict(self, arr: np.ndarray,
                deadline_ms: Optional[float] = None) -> np.ndarray:
        """Admission → (deadline-aware) batch formation → dispatch.
        Raises the typed errors the HTTP layer maps to 429/503/504/500."""
        if not self.breaker.allow():
            raise BreakerOpenError(self.breaker.retry_after())
        dl_ms = (self.default_deadline_ms if deadline_ms is None
                 else float(deadline_ms))
        deadline = (time.monotonic() + dl_ms / 1000.0
                    if dl_ms and dl_ms > 0 else None)
        obs = self.pi.submit(arr, deadline=deadline)  # QueueFullError ⇒ 429
        try:
            # the extra beat past the deadline covers a batch already ON
            # the device when the deadline passed — eviction only happens
            # at batch formation, so a dispatched request may still answer
            out = obs.get(timeout=(dl_ms / 1000.0 + 5.0)
                          if deadline is not None else None)
        except DeadlineExpiredError:
            raise
        except TimeoutError:
            # result never materialized inside deadline + slack: to the
            # client this is the same 504; not proven to be a model fault,
            # so it does not feed the breaker
            raise DeadlineExpiredError(
                "result not ready within deadline (+5s dispatch slack)")
        except BaseException as e:
            self.breaker.record_failure()
            raise ModelDispatchError(f"{type(e).__name__}: {e}") from e
        self.breaker.record_success()
        if self.feature_shape is None:
            # learned from the first success: later wrong-shaped requests
            # become 400s at the guard instead of dispatch failures that
            # count against the model's breaker
            self.feature_shape = tuple(arr.shape[1:])
        if deadline is not None and time.monotonic() > deadline:
            # dispatched in time but finished late (e.g. a slow batch
            # already on the device when the deadline passed): the answer
            # is worthless to the caller — 504, so a 200 ALWAYS means the
            # deadline was met (the model stays healthy: no breaker hit)
            raise DeadlineExpiredError("result completed after the "
                                       "deadline; discarded")
        return out

    def stats(self) -> dict:
        st = self.pi.stats()
        return {
            "requests_served": st["requests_served"],
            "batches_dispatched": st["batches_dispatched"],
            "queue": st["queue"],
            "batch_size": st["batch_size"],
            "hot_swap": st["hot_swap"],
            "warmed": self.warmed,
            "quantized": self.quantized,
            "input_scale": self.input_scale,
            "breaker": self.breaker.as_dict(),
            "default_deadline_ms": self.default_deadline_ms,
        }


class GenerateEndpoint:
    """One generative model behind ``POST /v1/models/<name>:generate``:
    a :class:`~deeplearning4j_tpu_torch.serving.decode.DecodeEngine` plus the
    HTTP-facing policy — token-budget cap, time-to-first-token and
    per-token deadline defaults, and the optional vocab that lets
    clients send ``"prompt"`` strings instead of ``"prompt_ids"``.
    Build through :meth:`ModelServer.add_generator`."""

    def __init__(self, name: str, engine: DecodeEngine, *,
                 default_max_tokens: int = 64,
                 max_max_tokens: int = 1024,
                 default_deadline_ms: float = 1000.0,
                 default_token_deadline_ms: float = 10000.0):
        self.name = name
        self.engine = engine
        self.default_max_tokens = int(default_max_tokens)
        self.max_max_tokens = int(max_max_tokens)
        self.default_deadline_ms = float(default_deadline_ms)
        self.default_token_deadline_ms = float(default_token_deadline_ms)
        self._stoi = (None if engine.vocab is None
                      else {c: i for i, c in enumerate(engine.vocab)})

    @property
    def warmed(self) -> bool:
        return self.engine.readiness()[0]

    def warmup(self):
        """Dispatch the decode slot ladder + prefill buckets and run the
        priming wave; flips this generator's readiness gate."""
        self.engine.warmup()
        return self

    def encode_prompt(self, prompt: str):
        if self._stoi is None:
            raise ValueError(
                f"generator '{self.name}' has no vocab — send "
                "'prompt_ids' (a list of token ids) instead of 'prompt'")
        try:
            return [self._stoi[c] for c in prompt]
        except KeyError as e:
            raise ValueError(f"prompt character {e} is not in generator "
                             f"'{self.name}'s vocab") from e

    def stats(self) -> dict:
        return {
            **self.engine.stats(),
            "default_max_tokens": self.default_max_tokens,
            "max_max_tokens": self.max_max_tokens,
            "default_deadline_ms": self.default_deadline_ms,
            "default_token_deadline_ms": self.default_token_deadline_ms,
            "has_vocab": self._stoi is not None,
        }

    def shutdown(self, drain: bool = False, drain_timeout_s: float = 10.0):
        self.engine.stop(drain=drain, drain_timeout_s=drain_timeout_s)


def _decode_inputs(body: dict, ep: "ModelEndpoint") -> np.ndarray:
    """Predict-body tensor decode: JSON ``inputs`` float lists, or the
    binary wire format ``{"x_b64", "dtype", "shape"}`` (serving/wire.py —
    base64 of raw little-endian array bytes). int8 payloads are only
    meaningful on a quantized endpoint, where they are decoded on the
    model's calibrated input grid. Raises KeyError (no tensor at all) or
    ValueError (malformed) — the HTTP layer maps both to 400."""
    if "inputs" in body:
        return np.asarray(body["inputs"], dtype=np.float32)
    if "x_b64" not in body:
        raise KeyError("inputs")
    return decode_array(
        body, int8_scale=ep.input_scale, allow_explicit_scale=False,
        int8_hint=f"model '{ep.name}' is not quantized (or its first "
                  "layer is not) — int8 payloads need the endpoint's "
                  "calibrated input scale; send float32")


class _Handler(BaseHTTPRequestHandler):
    server_ref: Optional["ModelServer"] = None
    # HTTP/1.1 so :generate can stream with chunked transfer encoding;
    # every non-stream response still carries Content-Length, so plain
    # keep-alive request/response traffic is unaffected
    protocol_version = "HTTP/1.1"
    # slow-client guard: a peer that stops sending mid-request times out
    # and frees its handler thread instead of holding it forever
    timeout = 30.0

    def log_message(self, fmt, *args):  # quiet
        pass

    def _body(self, body: bytes, content_type: str, code: int = 200,
              retry_after_s: Optional[float] = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if retry_after_s is not None:
            self.send_header("Retry-After",
                             str(max(1, math.ceil(retry_after_s))))
        if code >= 400:
            # error paths may answer before consuming the request body
            # (404/413/...), which under keep-alive would poison the next
            # request on the reused connection — close it instead
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up; the server must not care

    def _json(self, obj, code: int = 200,
              retry_after_s: Optional[float] = None):
        self._body(json.dumps(obj).encode(), "application/json", code,
                   retry_after_s=retry_after_s)

    def _error(self, code: int, reason: str, message: str,
               retry_after_s: Optional[float] = None):
        self._json({"error": message, "reason": reason}, code,
                   retry_after_s=retry_after_s)

    # ----------------------------------------------------------------- GET
    def do_GET(self):
        srv = type(self).server_ref
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json({"ok": True, "draining": srv.draining,
                        "models": sorted(srv.endpoints),
                        "indexes": sorted(srv.indexes),
                        "generators": sorted(srv.generators)})
        elif path == "/readyz":
            ready, reasons = srv.readiness()
            if ready:
                self._json({"ready": True})
            else:
                self._json({"ready": False, "reasons": reasons}, 503)
        elif path == "/metrics":
            from deeplearning4j_tpu_torch.obs.exporters import prometheus_text
            self._body(prometheus_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/v1/models":
            self._json({"models": {n: ep.stats()
                                   for n, ep in srv.endpoints.items()},
                        "generators": {n: g.stats()
                                       for n, g in srv.generators.items()}})
        elif path == "/v1/indexes":
            self._json({"indexes": {n: ep.stats()
                                    for n, ep in srv.indexes.items()}})
        elif path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            ep = srv.endpoints.get(name)
            if ep is not None:
                self._json({"model": name, **ep.stats()})
            elif name in srv.generators:
                self._json({"model": name,
                            **srv.generators[name].stats()})
            else:
                self._error(404, "unknown_model", f"no model '{name}'")
        elif path.startswith("/v1/indexes/"):
            name = path[len("/v1/indexes/"):]
            ep = srv.indexes.get(name)
            if ep is None:
                self._error(404, "unknown_index", f"no index '{name}'")
            else:
                self._json({"index": name, **ep.stats()})
        else:
            self._error(404, "not_found", "not found")

    # ---------------------------------------------------------------- POST
    def do_POST(self):
        srv = type(self).server_ref
        path = urlparse(self.path).path
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            self._do_predict(srv, path)
        elif path.startswith("/v1/models/") and path.endswith(":generate"):
            self._do_generate(srv, path)
        elif path.startswith("/v1/indexes/") and path.endswith(":query"):
            self._do_query(srv, path)
        else:
            self._error(404, "not_found", "not found")

    def _do_predict(self, srv, path):
        name = path[len("/v1/models/"):-len(":predict")]
        ep = srv.endpoints.get(name)
        if ep is None:
            self._error(404, "unknown_model", f"no model '{name}'")
            return
        length, err = parse_content_length(self.headers, srv.max_body_bytes)
        if err is not None:
            code, message = err
            self._error(code, "bad_request" if code == 400
                        else "body_too_large", message)
            return
        srv._m_requests.inc()
        # drain check + in-flight enter are ATOMIC: drain() observes a
        # complete count — a request is either shed or tracked, never
        # silently in between
        if not srv._enter_request():
            srv._m_drain_rejected.inc()
            self._error(503, "draining",
                        "server is draining; retry against another replica",
                        retry_after_s=srv.retry_after_s)
            return
        t0 = time.perf_counter()
        try:
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                arr = _decode_inputs(body, ep)
                deadline_ms = body.get(
                    "deadline_ms", self.headers.get("X-Deadline-Ms"))
                if deadline_ms is not None:
                    deadline_ms = float(deadline_ms)
            except KeyError:
                self._error(400, "bad_request", "body needs an 'inputs' "
                            "array ({\"inputs\": [[...], ...]}) or the "
                            "binary form {\"x_b64\", \"dtype\", \"shape\"}")
                return
            except (ValueError, TypeError) as e:
                self._error(400, "bad_request", f"malformed request: {e}")
                return
            if arr.ndim < 2 or arr.shape[0] < 1:
                self._error(400, "bad_request",
                            "'inputs' needs a leading batch axis "
                            f"(got shape {arr.shape})")
                return
            if ep.feature_shape is not None and \
                    tuple(arr.shape[1:]) != ep.feature_shape:
                self._error(400, "bad_request",
                            f"model '{name}' takes features of shape "
                            f"{ep.feature_shape}; got {tuple(arr.shape[1:])}")
                return
            try:
                out = ep.predict(arr, deadline_ms=deadline_ms)
            except QueueFullError as e:
                srv._m_shed.inc()
                self._error(429, "shed", str(e),
                            retry_after_s=srv.retry_after_s)
                return
            except BreakerOpenError as e:
                srv._m_breaker_rejected.inc()
                self._error(503, "breaker_open",
                            f"model '{name}' is failing; breaker open",
                            retry_after_s=e.retry_after_s)
                return
            except DeadlineExpiredError as e:
                srv._m_expired.inc()
                srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)
                self._error(504, "deadline_expired", str(e))
                return
            except ModelDispatchError as e:
                srv._m_errors.inc()
                self._error(500, "dispatch_failed",
                            f"inference failed: {e}")
                return
            srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)
            self._json({
                "model": name,
                "outputs": np.asarray(out).tolist(),
                "checkpoint_step": ep.pi.current_checkpoint_step,
            })
        finally:
            srv._exit_request()

    def _do_generate(self, srv, path):
        """``POST /v1/models/<name>:generate`` — admit a generative
        session on the model's DecodeEngine and deliver its tokens,
        either streamed as SSE over chunked HTTP or collected into one
        JSON body. The 429/503/504 taxonomy applies up to the first
        token; afterwards deadline faults become typed in-band events."""
        name = path[len("/v1/models/"):-len(":generate")]
        gep = srv.generators.get(name)
        if gep is None:
            self._error(404, "unknown_model", f"no generator '{name}'")
            return
        length, err = parse_content_length(self.headers, srv.max_body_bytes)
        if err is not None:
            code, message = err
            self._error(code, "bad_request" if code == 400
                        else "body_too_large", message)
            return
        srv._m_requests.inc()
        if not srv._enter_request():
            srv._m_drain_rejected.inc()
            self._error(503, "draining",
                        "server is draining; retry against another replica",
                        retry_after_s=srv.retry_after_s)
            return
        t0 = time.perf_counter()
        sess = None
        try:
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                if "prompt_ids" in body:
                    prompt_ids = [int(i) for i in body["prompt_ids"]]
                elif "prompt" in body:
                    prompt_ids = gep.encode_prompt(str(body["prompt"]))
                else:
                    raise ValueError(
                        "body needs 'prompt_ids' (a list of token ids) "
                        "or 'prompt' (a string, on generators with a "
                        "vocab)")
                max_tokens = int(body.get("max_tokens",
                                          gep.default_max_tokens))
                if not 1 <= max_tokens <= gep.max_max_tokens:
                    raise ValueError(f"max_tokens must be in "
                                     f"[1, {gep.max_max_tokens}]; "
                                     f"got {max_tokens}")
                temperature = float(body.get("temperature", 1.0))
                if not (temperature >= 0.0):  # also rejects NaN
                    raise ValueError(
                        f"temperature must be >= 0; got {temperature}")
                top_k = int(body.get("top_k", 0))
                eos_id = body.get("eos_id")
                stream = bool(body.get("stream", True))
                deadline_ms = body.get(
                    "deadline_ms", self.headers.get("X-Deadline-Ms"))
                deadline_ms = (gep.default_deadline_ms if deadline_ms
                               is None else float(deadline_ms))
                token_deadline_ms = float(body.get(
                    "token_deadline_ms", gep.default_token_deadline_ms))
            except (ValueError, TypeError, KeyError) as e:
                self._error(400, "bad_request", f"malformed request: {e}")
                return
            try:
                sess = gep.engine.open_session(
                    prompt_ids, max_tokens=max_tokens,
                    temperature=temperature, top_k=top_k,
                    eos_id=None if eos_id is None else int(eos_id))
            except SessionLimitError as e:
                srv._m_shed.inc()
                self._error(429, "shed", str(e),
                            retry_after_s=srv.retry_after_s)
                return
            except EngineStoppedError as e:
                srv._m_drain_rejected.inc()
                self._error(503, "draining", str(e),
                            retry_after_s=srv.retry_after_s)
                return
            except ValueError as e:
                self._error(400, "bad_request", f"malformed request: {e}")
                return
            # time-to-first-token deadline: nothing has been written yet,
            # so a miss still gets a proper 504 status line
            first = sess.next_event(
                timeout_s=deadline_ms / 1000.0 if deadline_ms > 0 else None)
            if first is None:
                sess.cancel()
                srv._m_expired.inc()
                srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)
                self._error(504, "deadline_expired",
                            f"no first token within {deadline_ms:.0f}ms")
                return
            if first["type"] == "error":
                srv._m_errors.inc()
                self._error(503 if first.get("error") == "engine_stopped"
                            else 500, first.get("error", "decode_failed"),
                            first.get("message", "decode failed"),
                            retry_after_s=srv.retry_after_s)
                return
            token_deadline_s = (token_deadline_ms / 1000.0
                                if token_deadline_ms > 0 else None)
            if stream:
                self._stream_generate(srv, name, sess, first,
                                      token_deadline_s, t0)
            else:
                self._collect_generate(srv, name, gep, sess, first,
                                       token_deadline_s, t0)
        finally:
            if sess is not None and not sess.finished:
                sess.cancel()  # free the slot at the next token boundary
            srv._exit_request()

    def _stream_generate(self, srv, name, sess, first, token_deadline_s,
                         t0):
        """SSE over chunked HTTP/1.1: one ``event:``/``data:`` frame per
        engine event, each its own chunk so tokens flush as they land.
        The terminal frame is always ``done`` or a typed ``error``."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()

        def send_event(ev: dict):
            payload = json.dumps({k: v for k, v in ev.items()
                                  if k != "type"})
            data = f"event: {ev['type']}\ndata: {payload}\n\n".encode()
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        terminal = None
        try:
            send_event({"type": "meta", "model": name,
                        "session": sess.id})
            send_event(first)
            if first["type"] in ("done", "error"):
                terminal = first
            else:
                for ev in sess.events(token_deadline_s):
                    send_event(ev)
                    if ev["type"] in ("done", "error"):
                        terminal = ev
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            sess.cancel()  # client went away mid-stream: free the slot
            return
        if terminal is not None and terminal["type"] == "error":
            if terminal.get("error") == "token_deadline_expired":
                srv._m_expired.inc()
            else:
                srv._m_errors.inc()
        srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)

    def _collect_generate(self, srv, name, gep, sess, first,
                          token_deadline_s, t0):
        """``stream: false`` — drain the whole generation, answer once."""
        events = [first]
        if first["type"] not in ("done", "error"):
            events.extend(sess.events(token_deadline_s))
        terminal = events[-1]
        if terminal["type"] == "error":
            if terminal.get("error") == "token_deadline_expired":
                srv._m_expired.inc()
                self._error(504, "deadline_expired",
                            terminal.get("message", "token deadline"))
            else:
                srv._m_errors.inc()
                self._error(503 if terminal.get("error") == "engine_stopped"
                            else 500,
                            terminal.get("error", "decode_failed"),
                            terminal.get("message", "decode failed"),
                            retry_after_s=srv.retry_after_s)
            return
        toks = [ev for ev in events if ev["type"] == "token"]
        srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)
        out = {"model": name, "session": sess.id,
               "token_ids": [ev["id"] for ev in toks],
               "tokens": len(toks), "reason": terminal.get("reason")}
        if gep.engine.vocab is not None:
            out["text"] = "".join(ev.get("text") or "" for ev in toks)
        self._json(out)

    def _do_query(self, srv, path):
        """``POST /v1/indexes/<name>:query`` — batched vector k-NN with
        the full serving contract (429 shed / 503 breaker / 504 deadline
        / drain), sharing the admission gate and SLO metrics with the
        predict route. Queries arrive as JSON ``{"queries": [[...]]}`` or
        the binary wire form ``{"x_b64","dtype","shape"}`` (int8 decoded
        on the index's table grid, or an explicit ``"scale"``); pass
        ``"b64": true`` to get ``indices_b64``/``distances_b64`` binary
        responses back."""
        from deeplearning4j_tpu_torch.retrieval.service import IndexDispatchError

        name = path[len("/v1/indexes/"):-len(":query")]
        ep = srv.indexes.get(name)
        if ep is None:
            self._error(404, "unknown_index", f"no index '{name}'")
            return
        length, err = parse_content_length(self.headers, srv.max_body_bytes)
        if err is not None:
            code, message = err
            self._error(code, "bad_request" if code == 400
                        else "body_too_large", message)
            return
        srv._m_requests.inc()
        if not srv._enter_request():
            srv._m_drain_rejected.inc()
            self._error(503, "draining",
                        "server is draining; retry against another replica",
                        retry_after_s=srv.retry_after_s)
            return
        t0 = time.perf_counter()
        try:
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                if "queries" in body:
                    q = np.asarray(body["queries"], dtype=np.float32)
                elif "x_b64" in body:
                    ix = ep.index
                    # any index that PUBLISHES a wire grid (int8 and
                    # int4 tables — queries stay on the int8 grid
                    # regardless of table codec) decodes int8 payloads
                    # on it; PQ/fp32 indexes publish none
                    scale = ix.scale
                    q = decode_array(
                        body, int8_scale=(float(body["scale"])
                                          if "scale" in body else scale),
                        int8_hint=f"index '{name}' publishes no int8 "
                                  "wire grid — int8 query payloads need "
                                  "a 'scale' field (or an int8/int4 "
                                  "index, whose table grid is used); "
                                  "send float32")
                else:
                    raise ValueError(
                        "body needs a 'queries' array ({\"queries\": "
                        "[[...], ...]}) or the binary form "
                        "{\"x_b64\", \"dtype\", \"shape\"}")
                if q.ndim == 1:
                    q = q[None, :]
                k = int(body.get("k", ep.k_default))
                deadline_ms = body.get(
                    "deadline_ms", self.headers.get("X-Deadline-Ms"))
                if deadline_ms is not None:
                    deadline_ms = float(deadline_ms)
                if q.ndim != 2 or q.shape[0] < 1 \
                        or q.shape[1] != ep.index.dim:
                    raise ValueError(
                        f"index '{name}' takes (b, {ep.index.dim}) "
                        f"queries; got shape {tuple(q.shape)}")
                if not 1 <= k <= ep.k_max:
                    raise ValueError(
                        f"k must be in [1, {ep.k_max}]; got {k}")
                if q.shape[0] > ep.max_query_rows:
                    raise ValueError(
                        f"batch of {q.shape[0]} queries exceeds this "
                        f"endpoint's max_query_rows={ep.max_query_rows}; "
                        "split the batch")
            except (ValueError, TypeError, KeyError) as e:
                self._error(400, "bad_request", f"malformed request: {e}")
                return
            try:
                idx, dist = ep.query(q, k, deadline_ms=deadline_ms)
            except QueueFullError as e:
                srv._m_shed.inc()
                self._error(429, "shed", str(e),
                            retry_after_s=srv.retry_after_s)
                return
            except BreakerOpenError as e:
                srv._m_breaker_rejected.inc()
                self._error(503, "breaker_open",
                            f"index '{name}' is failing; breaker open",
                            retry_after_s=e.retry_after_s)
                return
            except DeadlineExpiredError as e:
                srv._m_expired.inc()
                srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)
                self._error(504, "deadline_expired", str(e))
                return
            except IndexDispatchError as e:
                srv._m_errors.inc()
                self._error(500, "dispatch_failed", f"query failed: {e}")
                return
            except ValueError as e:
                # admission-time validation (shape/k/rows drift between
                # the HTTP checks and submit, e.g. across a hot-swap):
                # still a caller error — 400, never a dead handler
                self._error(400, "bad_request", f"malformed request: {e}")
                return
            srv._m_request_ms.observe((time.perf_counter() - t0) * 1e3)
            srv._m_requests_retrieval.inc()
            out = {"index": name, "k": k}
            labels = ep.index.labels
            if body.get("b64"):
                # fixed response dtypes: indices int32 LE, distances
                # float32 LE, both of the stated shape
                out["indices_b64"] = encode_array(
                    np.asarray(idx, np.int32), "indices_b64")["indices_b64"]
                out["distances_b64"] = encode_array(
                    np.asarray(dist, np.float32),
                    "distances_b64")["distances_b64"]
                out["shape"] = [int(s) for s in np.asarray(idx).shape]
            else:
                out["indices"] = np.asarray(idx).tolist()
                out["distances"] = np.asarray(dist).tolist()
                if labels is not None:
                    out["labels"] = [[labels[i] if 0 <= i < len(labels)
                                      else None for i in row]
                                     for row in np.asarray(idx)]
            self._json(out)
        finally:
            srv._exit_request()


class ModelServer:
    """Multi-model HTTP serving front (see module docstring).

    ``ModelServer({"iris": net}).start()`` builds a batched
    ``ParallelInference`` per model (bounded queue, immediate shed) and
    serves them behind one port; pass a ``ParallelInference`` instead of
    a model to control batching/bucketing/hot-swap yourself, or a
    :class:`ModelEndpoint` to control everything."""

    def __init__(self, models: Optional[Dict[str, object]] = None, *,
                 port: int = 0, bind_address: str = "127.0.0.1",
                 max_body_bytes: int = 8 << 20,
                 default_deadline_ms: float = 1000.0,
                 retry_after_s: float = 1.0,
                 queue_depth: int = 256, batch_limit: int = 32,
                 compile_cache_dir: Optional[str] = None):
        # loopback by default, like the UI/kNN servers: exposing an
        # unauthenticated predict endpoint beyond the host is an opt-in
        if compile_cache_dir is not None:
            raise NotImplementedError(
                "ModelServer(compile_cache_dir=): the PyTorch port compiles "
                "no programs and has no compiled-program cache (ROADMAP §A7)")
        self.compile_cache_dir = None
        self.port = port
        self.bind_address = bind_address
        self.max_body_bytes = int(max_body_bytes)
        self.default_deadline_ms = float(default_deadline_ms)
        self.retry_after_s = float(retry_after_s)
        self._default_queue_depth = int(queue_depth)
        self._default_batch_limit = int(batch_limit)
        self.endpoints: Dict[str, ModelEndpoint] = {}
        self.indexes: Dict[str, object] = {}  # name -> IndexEndpoint
        self.generators: Dict[str, GenerateEndpoint] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._warmup_thread: Optional[threading.Thread] = None
        self._state = threading.Condition()
        self._inflight = 0
        self._draining = False
        from deeplearning4j_tpu_torch.obs.registry import (absorb_model_server,
                                                           get_registry)
        reg = get_registry()
        self._m_requests = reg.counter(
            "serving_http_requests", unit="requests",
            help="predict requests received over HTTP")
        self._m_shed = reg.counter(
            "serving_requests_shed", unit="requests",
            help="requests shed with 429 because the bounded admission "
                 "queue was full (load shedding, never unbounded growth)")
        self._m_expired = reg.counter(
            "serving_requests_expired", unit="requests",
            help="requests answered 504 after their deadline expired "
                 "(evicted before device dispatch)")
        self._m_breaker_rejected = reg.counter(
            "serving_breaker_rejected", unit="requests",
            help="requests answered 503 fast while a model's circuit "
                 "breaker was open")
        self._m_drain_rejected = reg.counter(
            "serving_drain_rejected", unit="requests",
            help="requests shed with 503 while the server drained")
        self._m_errors = reg.counter(
            "serving_request_errors", unit="requests",
            help="predict requests that failed in model dispatch (500)")
        self._m_requests_retrieval = reg.counter(
            "serving_retrieval_requests", unit="requests",
            help="retrieval :query requests answered 200 over HTTP")
        self._m_request_ms = reg.histogram(
            "serving_request_ms", unit="ms",
            help="end-to-end HTTP predict latency for admitted requests "
                 "(queue wait + batch formation + dispatch)")
        self._m_inflight = reg.gauge(
            "serving_inflight_requests", unit="requests",
            help="predict requests currently inside the server "
                 "(admitted, not yet answered)")
        absorb_model_server(reg, self)
        for name, m in (models or {}).items():
            self.add_model(name, m)

    # ---------------------------------------------------------- model mgmt
    def add_model(self, name: str, model, *, warmup_example=None,
                  warmup_buckets=None, breaker: Optional[CircuitBreaker]
                  = None, default_deadline_ms: Optional[float] = None,
                  queue_depth: Optional[int] = None,
                  batch_limit: Optional[int] = None,
                  fold_bn: bool = False, quantize=None,
                  weight_bits: int = 8, checkpoint_manager=None,
                  checkpoint_poll_secs: Optional[float] = None,
                  tuning=None) -> ModelEndpoint:
        """Register a model (several nets behind one server, each with its
        own ``ParallelInference``, queue and breaker). ``quantize`` takes a
        ``quant.CalibrationRecord``: the endpoint serves the int8 lowering
        (``ParallelInference(quantize=)``, with ``weight_bits`` 8 or 4) —
        re-applied on every checkpoint hot-swap — and accepts int8 binary
        predict payloads. ``tuning`` takes an autotuner ``TuningRecord``
        (``ParallelInference(tuning=)``: verified against the model, its
        ladder warmed; a model restored with a record brings it along).
        The endpoint's ``ParallelInference`` runs on the model's device."""
        if name in self.endpoints:
            raise ValueError(f"model '{name}' already registered")
        if (quantize is not None or tuning is not None) \
                and isinstance(model, (ModelEndpoint, ParallelInference)):
            # a pre-built PI/endpoint already owns its serving graph —
            # silently dropping the record would serve untuned/fp32 while
            # the caller believes the record is applied
            raise ValueError(
                "add_model(quantize=/tuning=) needs the raw network — pass "
                "the model itself, or build the ParallelInference with "
                "quantize=/tuning= and register that")
        if isinstance(model, ModelEndpoint):
            ep = model
            ep.name = name
        elif isinstance(model, ParallelInference):
            ep = ModelEndpoint(
                name, model, warmup_example=warmup_example,
                warmup_buckets=warmup_buckets, breaker=breaker,
                default_deadline_ms=(self.default_deadline_ms
                                     if default_deadline_ms is None
                                     else default_deadline_ms))
        else:
            pi = ParallelInference(
                model,
                batch_limit=(self._default_batch_limit if batch_limit is None
                             else batch_limit),
                queue_depth=(self._default_queue_depth if queue_depth is None
                             else queue_depth),
                queue_put_timeout_ms=0.0,  # over capacity ⇒ IMMEDIATE 429
                fold_bn=fold_bn, quantize=quantize, weight_bits=weight_bits,
                tuning=tuning, checkpoint_manager=checkpoint_manager,
                checkpoint_poll_secs=checkpoint_poll_secs, device=model.device)
            ep = ModelEndpoint(
                name, pi, warmup_example=warmup_example,
                warmup_buckets=warmup_buckets, breaker=breaker,
                default_deadline_ms=(self.default_deadline_ms
                                     if default_deadline_ms is None
                                     else default_deadline_ms),
                owns_pi=True)
        self.endpoints[name] = ep
        return ep

    def add_generator(self, name: str, model, *,
                      max_sessions: int = 64, min_slots: int = 8,
                      prefill_buckets: Sequence[int] = (16, 64, 256),
                      vocab: Optional[Sequence[str]] = None, seed: int = 0,
                      default_max_tokens: int = 64,
                      max_max_tokens: int = 1024,
                      default_deadline_ms: Optional[float] = None,
                      default_token_deadline_ms: float = 10000.0,
                      checkpoint_manager=None,
                      checkpoint_poll_secs: Optional[float] = None,
                      hot_swap_policy: str = "carry") -> GenerateEndpoint:
        """Register a generative (autoregressive) model behind
        ``POST /v1/models/<name>:generate``. Builds a
        :class:`~deeplearning4j_tpu_torch.serving.decode.DecodeEngine` (pass
        one directly to control the slot ladder yourself) and starts its
        decode worker; the slot-ladder warmup rides the server's warmup
        pass and gates ``/readyz``. ``checkpoint_manager`` enables
        mid-generation hot-swap (``hot_swap_policy`` "carry" keeps
        session carries across the param swap, "reprefill" rebuilds them
        from prompt + generated history under the new params)."""
        if name in self.generators:
            raise ValueError(f"generator '{name}' already registered")
        if isinstance(model, DecodeEngine):
            engine = model
        else:
            engine = DecodeEngine(model, max_sessions=max_sessions,
                                  min_slots=min_slots,
                                  prefill_buckets=prefill_buckets,
                                  seed=seed, vocab=vocab)
        engine.start()
        if checkpoint_manager is not None:
            engine.start_hot_swap(
                checkpoint_manager,
                poll_secs=(5.0 if checkpoint_poll_secs is None
                           else checkpoint_poll_secs),
                policy=hot_swap_policy)
        gep = GenerateEndpoint(
            name, engine, default_max_tokens=default_max_tokens,
            max_max_tokens=max_max_tokens,
            default_deadline_ms=(self.default_deadline_ms
                                 if default_deadline_ms is None
                                 else default_deadline_ms),
            default_token_deadline_ms=default_token_deadline_ms)
        self.generators[name] = gep
        return gep

    def add_index(self, name: str, index, *, k_default: int = 10,
                  k_max: int = 128,
                  default_deadline_ms: Optional[float] = None,
                  queue_depth: Optional[int] = None,
                  batch_limit: int = 64,
                  breaker: Optional[CircuitBreaker] = None,
                  warmup_queries: int = 256):
        """Register a vector index (``retrieval/``) behind
        ``POST /v1/indexes/<name>:query`` with the SAME serving contract
        as models: bounded admission (429), per-request deadlines (504),
        circuit breaker (503), drain, warmup-gated readiness and the SLO
        metrics. Pass a ``retrieval.IndexEndpoint`` to control batching
        yourself, or any index (BruteForceIndex/IVFIndex) for the
        defaults. Hot-swap a rebuilt index under load via the returned
        endpoint's ``swap_index()``."""
        from deeplearning4j_tpu_torch.retrieval.service import IndexEndpoint

        if name in self.indexes:
            raise ValueError(f"index '{name}' already registered")
        if isinstance(index, IndexEndpoint):
            ep = index
            ep.name = name
        else:
            ep = IndexEndpoint(
                name, index, k_default=k_default, k_max=k_max,
                default_deadline_ms=(self.default_deadline_ms
                                     if default_deadline_ms is None
                                     else default_deadline_ms),
                queue_depth=(self._default_queue_depth if queue_depth is None
                             else queue_depth),
                batch_limit=batch_limit, breaker=breaker,
                warmup_queries=warmup_queries)
        self.indexes[name] = ep
        return ep

    # ------------------------------------------------------------ lifecycle
    def start(self, warmup: bool = True,
              warmup_async: bool = True) -> "ModelServer":
        """Bind and serve. ``warmup=True`` runs every endpoint's bucket
        ladder once (async by default — the port answers immediately,
        ``/readyz`` flips to 200 when compilation finishes; pass
        ``warmup_async=False`` to block until ready)."""
        handler = type("BoundServingHandler", (_Handler,),
                       {"server_ref": self})
        # socketserver's default listen backlog is 5: a burst of
        # simultaneous connects (far-above-capacity offered load — exactly
        # what this tier exists to absorb) can then overflow the TCP
        # accept queue and surface as kernel connection RESETS instead of
        # the admission layer's typed 429s. Deepen the backlog so sheds
        # happen in OUR code, with Retry-After, not in the kernel's.
        server_cls = type("BacklogThreadingHTTPServer",
                          (ThreadingHTTPServer,),
                          {"request_queue_size": 128})
        self._httpd = server_cls((self.bind_address, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="model-server", daemon=True)
        self._thread.start()
        if warmup:
            if warmup_async:
                self._warmup_thread = threading.Thread(
                    target=self.warmup, name="serving-warmup", daemon=True)
                self._warmup_thread.start()
            else:
                self.warmup()
        return self

    def warmup(self):
        """Run every endpoint's warmup ladder (gates ``/readyz``) —
        model bucket ladders, index (bucket × k-rung) ladders and decode
        slot ladders alike."""
        for ep in (list(self.endpoints.values())
                   + list(self.indexes.values())
                   + list(self.generators.values())):
            try:
                ep.warmup()
            except Exception:
                log.exception("warmup failed for endpoint '%s'; it "
                              "stays not-ready", ep.name)
        return self

    def readiness(self):
        unwarmed = sorted(n for n, ep in self.endpoints.items()
                          if not ep.warmed)
        unwarmed_ix = sorted(n for n, ep in self.indexes.items()
                             if not ep.warmed)
        unwarmed_gen = sorted(n for n, g in self.generators.items()
                              if not g.warmed)
        reasons = []
        if unwarmed:
            reasons.append(f"warmup pending: {unwarmed}")
        if unwarmed_ix:
            reasons.append(f"index warmup pending: {unwarmed_ix}")
        if unwarmed_gen:
            reasons.append(f"decode warmup pending: {unwarmed_gen}")
        if self.draining:
            reasons.append("draining")
        return (not reasons, reasons)

    @property
    def draining(self) -> bool:
        with self._state:
            return self._draining

    @property
    def inflight(self) -> int:
        with self._state:
            return self._inflight

    def _enter_request(self) -> bool:
        with self._state:
            if self._draining:
                return False
            self._inflight += 1
            self._m_inflight.set(self._inflight)
            return True

    def _exit_request(self):
        with self._state:
            self._inflight -= 1
            self._m_inflight.set(self._inflight)
            self._state.notify_all()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: new arrivals shed (503), every in-flight
        request completes — zero dropped. Returns whether in-flight hit
        zero inside the timeout. Idempotent; ``undrain()`` reverses it
        (e.g. after a hot-swap rollout step)."""
        deadline = time.monotonic() + timeout_s
        with self._state:
            self._draining = True
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._state.wait(remaining)
            return True

    def undrain(self):
        with self._state:
            self._draining = False

    def stop(self, drain: bool = True, drain_timeout_s: float = 30.0):
        """Drain (unless told not to), stop the listener, shut down every
        endpoint's ``ParallelInference`` this server built."""
        if drain:
            self.drain(timeout_s=drain_timeout_s)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for ep in self.endpoints.values():
            if ep.owns_pi:
                ep.pi.shutdown()
        for iep in self.indexes.values():
            iep.shutdown()
        for gep in self.generators.values():
            # server-level drain above already waited out live streams;
            # this stops the decode worker (bounded) and error-terminates
            # anything still stuck
            gep.shutdown(drain=drain, drain_timeout_s=drain_timeout_s)

    @property
    def address(self) -> str:
        return f"http://{self.bind_address}:{self.port}"
