"""The port's host-side observability (``obs/``) against the JAX package's,
on the CPU: the same observations into a fresh registry of each package
give the same p50/p95/p99 and the same Prometheus text; the tracer's spans
land in the same histograms; a flight-recorder dump and an event log the
port writes are read back by the JAX package's readers; the checkpoint
manager's counters are absorbed at scrape time. Observations are drawn
from numpy with fixed seeds; clocks are injected, so nothing depends on
wall time. Everything compares exactly: both packages run the same host
arithmetic.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.checkpoint.storage import ObjectStoreBackend as JaxObjectStore
from deeplearning4j_tpu.obs import exporters as jexp
from deeplearning4j_tpu.obs import flight as jflight
from deeplearning4j_tpu.obs import registry as jreg
from deeplearning4j_tpu.obs import trace as jtrace

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, ObjectStoreBackend
from deeplearning4j_tpu_torch.obs import flight as pflight


def _fill(reg, values, counts):
    h = reg.histogram("step_ms", unit="ms", help="step wall time")
    for v in values:
        h.observe(v)
    reg.histogram("tiny_ms", unit="ms", help="custom buckets",
                  buckets=(0.5, 1.0, 2.0)).observe(1.5)
    c = reg.counter("bytes_written_total", unit="bytes", help="bytes written")
    for n in counts:
        c.inc(n)
    reg.gauge("queue_depth", unit="items", help="queued items").set(counts[-1])
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_observations_same_quantiles_and_prometheus_text(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(2.0, 1.5, 500), [0.0, 0.05, 7e4]]).tolist()
    counts = rng.integers(0, 1000, 20).tolist()
    jh = _fill(jreg.MetricsRegistry(), values, counts)
    preg = obs.MetricsRegistry()
    ph = _fill(preg, values, counts)
    for q in (0.5, 0.95, 0.99, 0.0, 1.0):
        assert ph.quantile(q) == jh.quantile(q)
    assert ph.as_dict() == jh.as_dict()
    jr = jreg.MetricsRegistry()
    _fill(jr, values, counts)
    assert obs.prometheus_text(preg) == jexp.prometheus_text(jr)


def test_registration_rules_match():
    for reg, err in ((obs.MetricsRegistry(), obs.MetricError),
                     (jreg.MetricsRegistry(), jreg.MetricError)):
        with pytest.raises(err):
            reg.counter("Bad-Name", unit="x", help="y")
        with pytest.raises(err):
            reg.gauge("no_unit", unit="", help="y")
        reg.counter("shared", unit="x", help="y")
        with pytest.raises(err):
            reg.histogram("shared", unit="x", help="y")


def test_tracer_spans_become_histograms_and_flight_dumps_cross():
    """Spans on an injected clock observe the same ``<span>_ms`` histogram
    in both packages; the port's flight dump and event log, written to an
    object store, read back with the JAX package's readers."""
    ticks = iter(np.arange(0.0, 10.0, 0.004).tolist())
    jticks = iter(np.arange(0.0, 10.0, 0.004).tolist())
    preg, jr = obs.MetricsRegistry(), jreg.MetricsRegistry()
    pt = obs.Tracer(enabled=True, clock=lambda: next(ticks), registry=preg)
    jt = jtrace.Tracer(enabled=True, clock=lambda: next(jticks), registry=jr)
    store = {}
    backend = ObjectStoreBackend(store)
    rec = pflight.FlightRecorder(capacity=4, store=backend, worker_id="w0")
    elog = obs.EventLog(backend, name="events.jsonl", flush_every=1000)
    pt.add_sink(rec)
    pt.add_sink(elog)
    for tracer in (pt, jt):
        for i in range(6):
            with tracer.span("train.step_host", step=i):
                pass
        tracer.event("checkpoint.commit", step=5)
    assert obs.prometheus_text(preg) == jexp.prometheus_text(jr)
    assert rec.flush("fault injection: test") == "flightrec-w0"
    jstore = JaxObjectStore(store)  # the same bucket, seen by the JAX package
    dump = jflight.latest_dump(jstore)
    assert dump["reason"] == "fault injection: test" and len(dump["events"]) == 4
    assert jflight.dump_tail_summary(dump, 2)[-1] == "event checkpoint.commit step=5"
    assert rec.tail_summary(1) == ["event checkpoint.commit step=5"]
    assert elog.flush()
    assert [r["name"] for r in jexp.read_event_log(jstore, "events.jsonl")] == \
        ["train.step_host"] * 6 + ["checkpoint.commit"]


def test_disabled_tracer_is_free_and_stopwatch_syncs():
    calls = []
    t = obs.Tracer(enabled=False, clock=lambda: calls.append(1) or 0.0)
    with t.span("x"):
        pass
    it = [1, 2]
    assert t.wrap_iter(it, "w") is it and not calls
    sw = obs.Stopwatch(clock=iter([1.0, 3.5]).__next__).start()
    assert sw.stop(sync={"a": [torch.ones(2)]}) == 2.5
    with pytest.raises(RuntimeError):
        obs.Stopwatch().stop()


def test_checkpoint_manager_is_absorbed_at_scrape(tmp_path):
    reg = obs.get_registry()
    cm = CheckpointManager(storage=ObjectStoreBackend(), async_write=False, device="cpu")
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(OutputLayer(n_out=2, loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    cm.save(MultiLayerNetwork(conf, device="cpu").init())
    scraped = reg.as_dict()
    assert scraped["checkpoint_saves_committed"]["value"] == 1
    assert scraped["checkpoint_commit_ms"]["count"] >= 1
    assert scraped["checkpoint_bytes_written_total"]["value"] > 0
    cm.close()
