"""Overload-safe model serving tier of the port (counterpart of
``deeplearning4j_tpu/serving``, with the same names).

An HTTP front-end (:mod:`~deeplearning4j_tpu_torch.serving.server`,
``ModelServer``) over ``parallel.ParallelInference``: continuous batching
into the pow2 bucket ladder, bounded admission with load shedding (429),
per-request deadlines honoured at batch formation (504), a per-model
circuit breaker (:mod:`~deeplearning4j_tpu_torch.serving.breaker`, fast
503), graceful drain, warmup-gated readiness, checkpoint hot swap and a
``/metrics`` scrape. Vector indexes serve behind ``:query`` through
``retrieval.IndexEndpoint``.

The generative tier (:mod:`~deeplearning4j_tpu_torch.serving.decode`) adds
continuous-batching autoregressive decode behind
``POST /v1/models/<name>:generate``: per-session recurrent state on the
card in a pow2 session-slot ladder, one step advancing every active
session per dispatch, tokens streamed back as SSE.

``python -m deeplearning4j_tpu_torch.serving`` serves checkpoint
directories from the command line (``serving/__main__.py``).
"""

from deeplearning4j_tpu_torch.serving.breaker import BreakerOpenError, CircuitBreaker
from deeplearning4j_tpu_torch.serving.decode import (DecodeEngine, DecodeSession,
                                                     EngineStoppedError,
                                                     SessionLimitError)
from deeplearning4j_tpu_torch.serving.server import (GenerateEndpoint, ModelDispatchError,
                                                     ModelEndpoint, ModelServer)
from deeplearning4j_tpu_torch.serving.wire import decode_array, encode_array

__all__ = ["BreakerOpenError", "CircuitBreaker", "DecodeEngine", "DecodeSession",
           "EngineStoppedError", "SessionLimitError", "GenerateEndpoint",
           "ModelDispatchError", "ModelEndpoint", "ModelServer", "decode_array",
           "encode_array"]
