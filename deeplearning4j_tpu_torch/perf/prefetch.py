"""Host-to-device transfer overlap (counterpart of
``deeplearning4j_tpu/perf/prefetch.py``).

A copy from pageable host memory inside the step loop serializes: the host
stages and ships batch N while the card idles, then the card computes while
the host idles. ``DevicePrefetchIterator`` double-buffers instead: it issues
batch N+1's copy before it hands batch N to the caller, so the copy rides
beside step N's kernels.

On a CUDA device each array of a batch goes through a pinned host buffer
that is reused across batches of one shape and dtype (allocating 77 MB of
pinned memory a batch costs more than the copy saves):

- the array is written into the buffer on the host; a buffer is not
  rewritten until the event recorded after its last copy has completed, so
  batch N+2 never overwrites a staging buffer whose copy to the card is
  still in flight;
- ``copy_(non_blocking=True)`` runs on a dedicated copy stream, into a
  tensor allocated there;
- when the batch is handed out, the consumer's stream waits on the event
  recorded after the copy, and each device tensor is marked with
  ``record_stream`` for the consumer's stream, so the caching allocator
  does not reuse its memory while the step still reads it.

All of it runs on the consumer's thread: an ``AsyncDataSetIterator`` under
it does host work only. On the CPU the arrays become CPU tensors and
nothing else changes.

Composes with the host-side ``AsyncDataSetIterator``, Async innermost::

    it = DevicePrefetchIterator(AsyncDataSetIterator(raw), device=dev)
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["DevicePrefetchIterator", "PinnedStager"]


class PinnedStager:
    """Pinned host buffers, ``slots`` per (shape, dtype), used in turn,
    and the copy stream. ``stage(a)`` returns ``(device tensor, event)``:
    the copy of ``a`` to the card, enqueued on the copy stream, and the
    event recorded after it. ``bytes_copied`` counts what went over."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = max(2, int(slots))
        self.stream = torch.cuda.Stream(device)
        self._rings: Dict[tuple, List[list]] = {}
        self._turn: Dict[tuple, int] = {}
        self.bytes_copied = 0

    def _slot(self, shape, dtype) -> list:
        key = (tuple(shape), dtype)
        ring = self._rings.setdefault(key, [])
        if len(ring) < self.slots:
            ring.append([torch.empty(shape, dtype=dtype, pin_memory=True), None])
            return ring[-1]
        i = self._turn.get(key, 0)
        self._turn[key] = (i + 1) % self.slots
        slot = ring[i]
        if slot[1] is not None:
            # the copy that last read this buffer must have landed before
            # the host writes the next batch into it
            slot[1].synchronize()
        return slot

    def stage(self, a):
        src = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        slot = self._slot(src.shape, src.dtype)
        buf = slot[0]
        buf.copy_(src)
        with torch.cuda.stream(self.stream):
            out = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            out.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        slot[1] = done
        self.bytes_copied += buf.numel() * buf.element_size()
        return out, done


class DevicePrefetchIterator(DataSetIterator):
    """Yield DataSets (or MultiDataSets) whose arrays are already on
    ``device`` (the port's device rule: ``cuda`` unless the caller passes
    ``device="cpu"``).

    ``place_fn`` overrides the placement: a ``ds -> ds`` callable whose
    result is yielded in the batch's place; returning the batch unchanged
    marks it passed through (``batches_passed_through``). ``mesh=`` (the
    JAX package's data-parallel sharding) raises until the port has
    meshes. ``lookahead`` is the number of batches in flight beyond the
    one being consumed. ``bind_epoch`` and ``iter_from`` pass through to
    the base where it has them."""

    def __init__(self, base, device=None, lookahead: int = 1, place_fn=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("DevicePrefetchIterator(mesh=) needs the port's "
                                      "device meshes, which are not in it yet (ROADMAP §A6)")
        self._base = base
        self.device = resolve_device(device)
        self._lookahead = max(1, int(lookahead))
        self._place_fn = place_fn
        self._stager: Optional[PinnedStager] = None
        self.batches_prefetched = 0
        self.batches_passed_through = 0

    @property
    def bytes_copied(self) -> int:
        return 0 if self._stager is None else self._stager.bytes_copied

    # ------------------------------------------------------------ placement
    def _place_array(self, a, events: list):
        if a is None:
            return None
        if isinstance(a, torch.Tensor) and a.device == self.device:
            return a
        if self.device.type != "cuda":
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(self.device)
        if self._stager is None:
            self._stager = PinnedStager(self.device, self._lookahead + 1)
        out, done = self._stager.stage(a)
        events.append(done)
        return out

    def _place(self, ds):
        """(placed batch, the events its copies recorded)."""
        if self._place_fn is not None:
            out = self._place_fn(ds)
            if out is ds:
                self.batches_passed_through += 1
            else:
                self.batches_prefetched += 1
            return out, []
        self.batches_prefetched += 1
        events: list = []
        if isinstance(ds, MultiDataSet):
            def place_list(arrs):
                return None if arrs is None else [self._place_array(a, events) for a in arrs]
            return MultiDataSet(place_list(ds.features), place_list(ds.labels),
                                place_list(ds.features_masks),
                                place_list(ds.labels_masks)), events
        return DataSet(*(self._place_array(a, events)
                         for a in (ds.features, ds.labels, ds.features_mask,
                                   ds.labels_mask))), events

    def _hand_out(self, placed):
        ds, events = placed
        if events:
            consumer = torch.cuda.current_stream(self.device)
            for ev in events:
                consumer.wait_event(ev)
            arrays = ([*ds.features, *ds.labels, *(ds.features_masks or []),
                       *(ds.labels_masks or [])] if isinstance(ds, MultiDataSet)
                      else [ds.features, ds.labels, ds.features_mask, ds.labels_mask])
            for t in arrays:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(consumer)
        return ds

    # ------------------------------------------------------------- iteration
    def _pump(self, source):
        buf: deque = deque()
        for ds in source:
            # a pre_processor set on this wrapper runs before placement
            if self.pre_processor is not None:
                ds = self.pre_processor(ds)
            buf.append(self._place(ds))
            if len(buf) > self._lookahead:
                yield self._hand_out(buf.popleft())
        while buf:
            yield self._hand_out(buf.popleft())

    def _generate(self):
        return self._pump(self._base)

    def __iter__(self):
        # iterating the base runs its own reset; the preprocessor is
        # applied in _pump
        return self._generate()

    # a seekable / epoch-aware base (datasets/sharded.py ShardedReader,
    # possibly under AsyncDataSetIterator): forward bind_epoch / iter_from,
    # through __getattr__ so hasattr() tells whether the base has them
    def __getattr__(self, name):
        if name == "bind_epoch":
            base_bind = getattr(self._base, name)

            def bind_epoch(provider):
                base_bind(provider)
                return self
            return bind_epoch
        if name == "iter_from":
            base_iter_from = getattr(self._base, name)

            def iter_from(start_batch):
                return self._pump(base_iter_from(start_batch))
            return iter_from
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def reset(self):
        if hasattr(self._base, "reset"):
            self._base.reset()

    def batch_size(self):
        return self._base.batch_size() if hasattr(self._base, "batch_size") else None

    def input_columns(self):
        return self._base.input_columns() if hasattr(self._base, "input_columns") else None

    def total_outcomes(self):
        return self._base.total_outcomes() if hasattr(self._base, "total_outcomes") else None
