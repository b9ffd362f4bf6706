"""StatsListener: per-iteration model/system stats into a StatsStorage
(counterpart of ``deeplearning4j_tpu/ui/stats.py``: the same records, key for
key).

Parity surface: reference
``deeplearning4j-ui-model/.../ui/stats/BaseStatsListener.java:44`` (collection
loop, :286 iterationDone), ``StatsListener.java``, ``api/StatsReport.java``
(score, timing, memory, learning rates, per-param histograms / mean / stdev /
mean-magnitudes for Parameters, Updates and Activations) and
``api/StatsInitializationReport.java`` (session/software/hardware/model info).

Design for the card: the statistics of every leaf are reduced on the leaf's
own device, in float64, and only scalars and histogram counts cross to the
host (the JAX listener copies every leaf to the host). One group of leaves
(parameters, updates or activations) is one flat float64 buffer with a
segment a leaf, and a report of a group makes two reads to the host: the
(count, mean, sum of squared deviations, mean magnitude, min, max) of every
segment (``torch.segment_reduce``), then, after the host has worked out each
leaf's histogram edges, the counts of every bin of every leaf (one
``index_add_`` over segment x bin ids). The JAX listener's rules hold:

- non-finite entries are dropped; an empty leaf gives zeros; ``lo == hi``
  becomes ``hi = lo + 1e-12``; stdev is ``ddof=1`` (0 for one entry);
- the counts equal ``np.histogram(a, bins, range=(lo, hi))``'s exactly: the
  edges are ``np.histogram_bin_edges`` of that range on the host (numpy's
  outer edges and ``np.linspace``), sent to the device, and each entry's bin
  is numpy's uniform-bin index ``int((a - first) / (last - first) * bins)``
  (a true division by a device scalar) with numpy's two corrections against
  the edges;
- "updates" are the difference, in the leaf's dtype, from a device copy of
  the previous report's leaves (the applied parameter delta over one report
  interval, as in the JAX package);
- activations are sampled by re-running ``feed_forward`` on the first
  example of the last fit batch (a ``MultiLayerNetwork``; the graph has no
  ``feed_forward``, as in the JAX package). ``needs_features`` asks the
  train step to keep that example (``nn/training.py``).

The static record names ``torch``, ``torch.version.cuda`` (``cuda``), the
device's name and the number of devices where the JAX one names ``jax`` and
its backend; the memory record reads ``torch.cuda.memory_allocated`` and
``torch.cuda.mem_get_info``'s total on a CUDA device. Sampling activations
and reading device memory swallow their errors, as the JAX listener does.
"""

from __future__ import annotations

import json
import socket
import sys
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

TYPE_ID = "StatsListener"

# per segment: count, mean, sum of squared deviations, mean magnitude, min, max
_N, _MEAN, _SS, _MAG, _LO, _HI = range(6)


def _flatten_params(params, prefix="") -> dict:
    """Flatten a list-of-dicts (MLN) or dict-of-dicts (CG) param tree into
    ``{"0_W": tensor, ...}`` / ``{"vertex_W": tensor}`` leaf names, mirroring
    the reference's ``layerIdx_paramName`` convention. Nested dicts (e.g.
    Bidirectional's fwd/bwd sub-params) join with ``_``."""
    out = {}
    if isinstance(params, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(params)]
    elif isinstance(params, dict):
        items = list(params.items())
    else:
        if params is not None:
            out[prefix.rstrip("_") or "param"] = params
        return out
    for name, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten_params(v, f"{prefix}{name}_"))
        elif v is not None:
            out[f"{prefix}{name}"] = v
    return out


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


class _Group:
    """The leaves of one group as one flat float64 buffer on their device."""

    def __init__(self, leaves: List[torch.Tensor]):
        dev = leaves[0].device
        self.lengths_host = [int(t.numel()) for t in leaves]
        self.total = sum(self.lengths_host)
        self.data = torch.cat([t.reshape(-1).to(device=dev, dtype=torch.float64)
                               for t in leaves])
        self.lengths = torch.tensor(self.lengths_host, dtype=torch.int64, device=dev)
        self.finite = torch.isfinite(self.data)

    def _per_entry(self, per_segment: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(per_segment, self.lengths, output_size=self.total)

    def _segments(self, values: torch.Tensor, how: str) -> torch.Tensor:
        return torch.segment_reduce(values, how, lengths=self.lengths, unsafe=True)

    def moments(self) -> np.ndarray:
        """(leaves, 6) float64 on the host: count, mean, sum of squared
        deviations, mean magnitude, min and max of each leaf's finite
        entries (min / max are +-inf for a leaf with none)."""
        a, fin = self.data, self.finite
        zero = a.new_zeros(())
        z = torch.where(fin, a, zero)
        n = self._segments(fin.to(torch.float64), "sum")
        per = n.clamp(min=1.0)
        mean = self._segments(z, "sum") / per
        dev = torch.where(fin, a - self._per_entry(mean), zero)
        ss = self._segments(dev * dev, "sum")
        mag = self._segments(z.abs(), "sum") / per
        lo = self._segments(torch.where(fin, a, a.new_full((), float("inf"))), "min")
        hi = self._segments(torch.where(fin, a, a.new_full((), float("-inf"))), "max")
        return torch.stack([n, mean, ss, mag, lo, hi], dim=1).cpu().numpy()

    def counts(self, edges: np.ndarray) -> np.ndarray:
        """(leaves, bins) int64 on the host: ``np.histogram``'s counts of each
        leaf's entries over that leaf's row of ``edges`` (leaves, bins + 1)."""
        a = self.data
        leaves, width = edges.shape
        bins = width - 1
        e = torch.as_tensor(edges, dtype=torch.float64).to(a.device)
        seg = self._per_entry(torch.arange(leaves, device=a.device))
        base = seg * width
        flat = e.reshape(-1)
        first, last = e[:, 0], e[:, bins]
        first_a = self._per_entry(first)
        last_a = self._per_entry(last)
        keep = self.finite & (a >= first_a) & (a <= last_a)
        a = torch.where(keep, a, first_a)  # a dropped entry lands in bin 0, then the spare
        idx = ((a - first_a) / self._per_entry(last - first) * bins).to(torch.int64)
        idx = idx - (idx == bins).to(torch.int64)
        idx = idx - (a < flat[base + idx]).to(torch.int64)
        up = (a >= flat[base + idx + 1]) & (idx != bins - 1)
        idx = idx + up.to(torch.int64)
        slot = torch.where(keep, base + idx, base + bins)  # dropped: the spare bin
        out = torch.zeros(leaves * width, dtype=torch.int64, device=a.device)
        out.index_add_(0, slot, torch.ones_like(slot))
        return out.reshape(leaves, width)[:, :bins].cpu().numpy()


def _hist_range(row) -> tuple:
    """(lo, hi) of one leaf's histogram: its finite extremes, hi nudged
    above lo when they are equal (the JAX listener's rule)."""
    lo, hi = float(row[_LO]), float(row[_HI])
    if lo == hi:
        hi = lo + 1e-12
    return lo, hi


def reduce_leaves(flat: Dict[str, object], bins: int, moments: bool = True,
                  histograms: bool = True) -> dict:
    """``{name: {"mean", "stdev", "mean_magnitude", "histogram"}}`` of every
    leaf, each entry the JAX listener's ``_stats_of`` / ``_histogram`` of that
    leaf; the leaves of one device are reduced there together."""
    out = {name: {} for name in flat}
    if not (moments or histograms) or not flat:
        return out
    by_dev: Dict[torch.device, List[str]] = {}
    tensors = {name: _as_tensor(v) for name, v in flat.items()}
    for name, t in tensors.items():
        by_dev.setdefault(t.device, []).append(name)
    for names in by_dev.values():
        group = _Group([tensors[n] for n in names])
        rows = group.moments()
        if histograms:
            edges = np.empty((len(names), bins + 1), np.float64)
            for i, row in enumerate(rows):
                rng = _hist_range(row) if row[_N] > 0 else (0.0, 1.0)
                edges[i] = np.histogram_bin_edges(np.empty(0, np.float64), bins=bins,
                                                  range=rng)
            counts = group.counts(edges)
        for i, (name, row) in enumerate(zip(names, rows)):
            n = int(row[_N])
            entry = out[name]
            if moments:
                if n == 0:
                    entry.update(mean=0.0, stdev=0.0, mean_magnitude=0.0)
                else:
                    entry.update(mean=float(row[_MEAN]),
                                 stdev=float(np.sqrt(row[_SS] / (n - 1))) if n > 1 else 0.0,
                                 mean_magnitude=float(row[_MAG]))
            if histograms:
                if n == 0:
                    entry["histogram"] = {"min": 0.0, "max": 0.0, "counts": [0] * bins}
                else:
                    lo, hi = _hist_range(row)
                    entry["histogram"] = {"min": lo, "max": hi,
                                          "counts": counts[i].tolist()}
    return out


def _histogram(arr, bins: int) -> dict:
    """The JAX listener's ``_histogram`` of one array or tensor."""
    return reduce_leaves({"a": arr}, bins, moments=False)["a"]["histogram"]


def _stats_of(arr) -> dict:
    """The JAX listener's ``_stats_of`` of one array or tensor."""
    return reduce_leaves({"a": arr}, 1, histograms=False)["a"]


class StatsListener(TrainingListener):
    """Collect score/timing/memory/param/update/activation stats every
    ``frequency`` iterations into ``storage`` (see module docstring).

    ``storage`` is any ``deeplearning4j_tpu_torch.storage.BaseStatsStorage``
    (or a router with the same write surface).
    """

    def __init__(self, storage, frequency: int = 1,
                 session_id: Optional[str] = None,
                 worker_id: Optional[str] = None,
                 histogram_bins: int = 20,
                 collect_histograms: bool = True,
                 collect_mean_stdev: bool = True,
                 collect_activations: bool = True,
                 collect_memory: bool = True):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id or str(uuid.uuid4())
        self.worker_id = worker_id or socket.gethostname()
        self.histogram_bins = histogram_bins
        self.collect_histograms = collect_histograms
        self.collect_mean_stdev = collect_mean_stdev
        self.collect_activations = collect_activations
        self.collect_memory = collect_memory
        self._init_reported = False
        self._start_time: Optional[float] = None
        self._last_report_time: Optional[float] = None
        self._last_params: Optional[dict] = None
        self._device: Optional[torch.device] = None
        self._examples_since = 0
        self._minibatches_since = 0
        self._total_examples = 0
        self._total_minibatches = 0

    @property
    def needs_features(self) -> bool:
        """Ask the train step to keep the batch's first example."""
        return self.collect_activations

    # -------------------------------------------------------------- reports
    def _report_init(self, model):
        dev = torch.device(getattr(model, "device", "cpu"))
        self._device = dev
        on_cuda = dev.type == "cuda"
        record = {
            "kind": "static", "session_id": self.session_id,
            "type_id": TYPE_ID, "worker_id": self.worker_id,
            "timestamp": time.time(),
            "software": {
                "python": sys.version.split()[0],
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "hostname": socket.gethostname(),
            },
            "hardware": {
                "device_kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
                "device_count": torch.cuda.device_count() if on_cuda else 1,
                "platform": dev.type,
            },
            "model": {
                "class": type(model).__name__,
                "num_params": int(model.num_params()),
                "param_shapes": {
                    k: list(v.shape) for k, v in
                    _flatten_params(model.params).items()},
            },
        }
        conf = getattr(model, "conf", None)
        if conf is not None and hasattr(conf, "to_json"):
            try:
                record["model"]["config"] = json.loads(conf.to_json())
            except Exception:
                pass
        self.storage.put_static_info(record)
        self._init_reported = True
        self._start_time = time.time()
        self._last_report_time = self._start_time

    def _memory_report(self) -> dict:
        import resource

        mem = {"host_rss_bytes":
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
        try:
            dev = self._device
            if dev is not None and dev.type == "cuda":
                mem["device_bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
                mem["device_bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
        except Exception:
            pass
        return mem

    def _param_group(self, flat: dict) -> dict:
        return reduce_leaves(flat, self.histogram_bins, moments=self.collect_mean_stdev,
                             histograms=self.collect_histograms)

    # ------------------------------------------------------------- listener
    def iteration_done(self, model, iteration: int, epoch: int):
        if not self._init_reported:
            self._report_init(model)
        batch = getattr(model, "last_batch_size", None) or 0
        self._examples_since += batch
        self._minibatches_since += 1
        self._total_examples += batch
        self._total_minibatches += 1
        if iteration % self.frequency != 0:
            return
        t0 = time.perf_counter()
        now = time.time()
        dt = max(now - (self._last_report_time or now), 1e-9)

        flat = {k: v.detach() for k, v in _flatten_params(model.params).items()}
        record = {
            "kind": "update", "session_id": self.session_id,
            "type_id": TYPE_ID, "worker_id": self.worker_id,
            "timestamp": now, "iteration": int(iteration),
            "epoch": int(epoch),
            "score": model.score(),
            "performance": {
                "total_runtime_ms": (now - self._start_time) * 1000.0,
                "total_examples": self._total_examples,
                "total_minibatches": self._total_minibatches,
                "examples_per_second": self._examples_since / dt,
                "minibatches_per_second": self._minibatches_since / dt,
            },
            "parameters": self._param_group(flat),
        }
        if self._last_params is not None:
            updates = {k: flat[k] - self._last_params[k]
                       for k in flat if k in self._last_params
                       and flat[k].shape == self._last_params[k].shape}
            record["updates"] = self._param_group(updates)
            # update:parameter mean-magnitude ratio — the dashboard's canonical
            # learning-health chart (reference TrainModule ratio plot)
            record["update_ratios"] = {
                k: (record["updates"][k]["mean_magnitude"]
                    / max(record["parameters"][k].get("mean_magnitude", 0.0), 1e-12))
                for k in record.get("updates", {})
                if "mean_magnitude" in record["updates"][k]}
        if self.collect_activations:
            acts = self._sample_activations(model)
            if acts:
                record["activations"] = acts
        if self.collect_memory:
            record["memory"] = self._memory_report()
        record["stats_collection_duration_ms"] = \
            (time.perf_counter() - t0) * 1000.0
        self.storage.put_update(record)
        # one source, two surfaces: the same record that feeds the
        # dashboard updates the MetricsRegistry (score / throughput
        # gauges) and flows into the trace/flight event pipeline
        from deeplearning4j_tpu_torch.obs.registry import publish_stats_update
        publish_stats_update(record)
        self._last_params = {k: v.clone() for k, v in flat.items()}
        self._last_report_time = now
        self._examples_since = 0
        self._minibatches_since = 0

    def _sample_activations(self, model) -> Optional[dict]:
        x = getattr(model, "_last_features", None)
        if x is None or not hasattr(model, "feed_forward"):
            return None
        try:
            acts = model.feed_forward(x)
        except Exception:
            return None
        return self._param_group({str(i): a for i, a in enumerate(acts)})
