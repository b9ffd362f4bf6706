"""Host-side observability of the port (counterpart of
``deeplearning4j_tpu/obs/``): metrics registry, span tracing, exporters
and the crash flight recorder.

- :mod:`~deeplearning4j_tpu_torch.obs.registry` — process-wide
  ``MetricsRegistry`` (counters / gauges / fixed-bucket histograms with
  p50/p95/p99, all with units + help text) and the duck-typed absorbers;
- :mod:`~deeplearning4j_tpu_torch.obs.trace` — explicit-clock host-side
  span tracer (disabled ⇒ near-zero-cost no-op), plus the synced bench
  ``Stopwatch``;
- :mod:`~deeplearning4j_tpu_torch.obs.exporters` — Prometheus text format
  and a JSONL event log through any ``StorageBackend``;
- :mod:`~deeplearning4j_tpu_torch.obs.flight` — bounded in-memory ring of
  recent spans/events flushed to storage on a crash and attached to
  ``CrashRecord`` post-mortems.

The checkpoint manager's commit/restore times and bytes land in the
registry; its save counters are absorbed at scrape time.
"""

from deeplearning4j_tpu_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricError, MetricsRegistry,
    absorb_checkpoint_manager, absorb_compile_watch, absorb_index_endpoint,
    absorb_inference_stats, absorb_model_server, absorb_training_stats,
    get_registry,
    publish_stats_update, watch_grad_compression, watch_training_stats)
from deeplearning4j_tpu_torch.obs.trace import (  # noqa: F401
    Stopwatch, Tracer, configure_tracer, get_tracer)
from deeplearning4j_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder, flush_flight_recorder, get_flight_recorder,
    install_flight_recorder, uninstall_flight_recorder)
from deeplearning4j_tpu_torch.obs.exporters import (  # noqa: F401
    EventLog, prometheus_text, read_event_log)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricError", "MetricsRegistry",
    "get_registry", "absorb_compile_watch", "absorb_training_stats",
    "watch_training_stats", "watch_grad_compression",
    "absorb_inference_stats", "absorb_checkpoint_manager",
    "absorb_index_endpoint",
    "publish_stats_update",
    "Tracer", "get_tracer", "configure_tracer", "Stopwatch",
    "FlightRecorder", "install_flight_recorder", "get_flight_recorder",
    "uninstall_flight_recorder", "flush_flight_recorder",
    "EventLog", "prometheus_text", "read_event_log",
]
