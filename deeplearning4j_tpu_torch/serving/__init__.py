"""Serving tier of the port: so far the circuit breaker that
``retrieval.IndexEndpoint`` uses. ``ModelServer`` (HTTP) comes later."""

from deeplearning4j_tpu_torch.serving.breaker import BreakerOpenError, CircuitBreaker

__all__ = ["BreakerOpenError", "CircuitBreaker"]
