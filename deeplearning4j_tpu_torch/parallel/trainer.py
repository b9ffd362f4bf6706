"""Data-parallel training over ``torch.distributed`` (counterpart of
``deeplearning4j_tpu/parallel/trainer.py``; reference ParallelWrapper
``ParallelWrapper.java:58`` and the Spark training masters).

The JAX package runs the network's own step with the global batch
sharded over the mesh's ``data`` axis; GSPMD puts the gradient all-reduce
into the step, an exact average every step. The port runs one process a
rank, each driving one device over a :class:`~deeplearning4j_tpu_torch.
parallel.mesh.Mesh`: each rank steps the network's own step
(``nn/training.py``) on its rows of the global batch inside
``nn/data_parallel.py::data_group``, which averages the trainable
gradients and the loss over the ranks (one flat all-reduce a dtype) and
takes batch-norm statistics over the global batch, before the gradient
compression and the updaters. Parameters stay replicated: every rank
applies the same update to the same parameters.

With ``tensor_parallel=True`` each leaf that ``tp_shardings`` shards over
the mesh's ``model`` axis lives on each rank as its slice only, and so do
its updater slots and compression residual (``parallel/mesh.py::
TensorParallel``): GSPMD's collectives become explicit. The step gathers
every sharded leaf whole over the ``model`` group through a
differentiable all-gather, runs the network's own forward and backward
on the whole leaves (the ranks of a model group see the same rows and
compute the same loss), takes each slice's gradient as its part of the
whole gradient, averages the gradients over the ``data`` group as above,
and updates this rank's slices. The numbers are the replicated run's.
Outside ``fit`` the model holds whole leaves again (gathered at its end);
the listeners' ``on_epoch_end`` sees whole leaves, and a checkpoint under
``fit`` holds every leaf whole (gathered for the steps on which the
manager saves, ``CheckpointManager.save_due``). A mesh with ``model``
above 1 without ``tensor_parallel`` keeps the parameters replicated, the
ranks of a model group computing the same step.

- :class:`ParallelWrapper` trains from a global iterator: each rank takes
  the rows of its data index of each batch (all of them at one rank).
- :class:`ClusterTrainer` adds the multi-process entry points:
  :meth:`~ClusterTrainer.initialize` (``init_process_group``, a no-op at
  one process), ``fit`` over a global iterator (each rank's row shard,
  ``parallel/sharding.py``), ``fit_local_shard`` over per-rank data with
  an equal-shard check at each epoch's first batch, the collective
  watchdog every ``watchdog_every`` steps, the ``train.step_host`` /
  ``train.step_device`` spans inside one watchdog call, and
  ``checkpoint_manager`` (rank 0 writes, the others barrier).
- :class:`EarlyStoppingParallelTrainer` routes each batch through either.

Kept from the JAX package: ragged batches (not dividing the data size)
dropped with one warning in an iterator, raised for a single DataSet;
epoch listeners once an epoch (``_EpochHooksSuppressed`` where a batch
goes through ``model.fit``); the resume skip; ``bind_epoch``;
``collect_stats``.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import data_parallel
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, TensorParallel, make_mesh

log = logging.getLogger(__name__)

__all__ = ["ParallelWrapper", "ClusterTrainer", "EarlyStoppingParallelTrainer"]


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


class _EpochHooksSuppressed:
    """Listener proxy forwarding everything but epoch hooks (used when a
    minibatch is routed through model.fit, which counts a full epoch)."""

    def __init__(self, inner):
        self._inner = inner

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _rows(ds, sl):
    def cut(a):
        return None if a is None else a[sl]
    if isinstance(ds, MultiDataSet):
        def cut_list(arrs):
            return None if arrs is None else [cut(a) for a in arrs]
        return MultiDataSet(cut_list(ds.features), cut_list(ds.labels),
                            cut_list(ds.features_masks), cut_list(ds.labels_masks))
    return DataSet(cut(ds.features), cut(ds.labels), features_mask=cut(ds.features_mask),
                   labels_mask=cut(ds.labels_mask))


def _map_opt_state(opt_state, fn):
    """``fn(slot_tree, key)`` over every updater slot tree of a network's
    updater state (a list a layer or a dict a vertex; ``count`` kept)."""
    keys = range(len(opt_state)) if isinstance(opt_state, list) else list(opt_state)
    out = {k: {name: (v if name == "count" else fn(v, k)) for name, v in opt_state[k].items()}
           for k in keys}
    return [out[k] for k in keys] if isinstance(opt_state, list) else out


def _num_examples(ds) -> int:
    f = ds.features[0] if isinstance(ds, MultiDataSet) else ds.features
    return int(f.shape[0])


class ParallelWrapper:
    """Data-parallel training of a network over a mesh of ranks.

    Example::

        pw = ParallelWrapper(net)           # make_mesh() of net's device
        pw.fit(iterator, num_epochs=3)

    No replicas in one process: the network is trained in place and
    ``net.params`` stays valid throughout."""

    def __init__(self, model, mesh=None, tensor_parallel: bool = False,
                 prefetch_buffer: int = 2, collect_stats: bool = False,
                 grad_compression=None):
        """``grad_compression`` (a ``parallel/compress.py`` scheme, e.g.
        ``ThresholdCompression()``) compresses the averaged gradient with
        error feedback in every step. A model restored from a compressed
        checkpoint already carries its scheme; passing a different one
        raises."""
        from deeplearning4j_tpu_torch.parallel.stats import TrainingStats
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(device=model.device)
        if self.mesh.device != model.device:
            raise ValueError(f"the mesh drives {self.mesh.device}, the model lives on "
                             f"{model.device}: build the model on the rank's device")
        self.tensor_parallel = tensor_parallel
        self.prefetch_buffer = prefetch_buffer
        self.grad_compression = grad_compression
        self._tp: Optional[TensorParallel] = None
        self._placed = False
        self._warned_ragged = False
        self.stats = TrainingStats() if collect_stats else None
        if self.stats is not None:
            from deeplearning4j_tpu_torch.obs.registry import (get_registry,
                                                               watch_training_stats)
            watch_training_stats(get_registry(), self.stats)

    @property
    def data_size(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    # ---- parameters ----
    def _place_params(self):
        """Replicated parameters: each rank already holds them on its
        device. Under tensor parallelism each rank keeps its slices of the
        parameters, updater slots and compression residual. Enables the
        compression scheme (the wrapper's, or one the model carries) and
        makes its state."""
        if self._placed:
            return
        m = self.model
        if m.params is None:
            m.init()
        scheme = (self.grad_compression if self.grad_compression is not None
                  else getattr(m, "grad_compression", None))
        if scheme is not None:
            from deeplearning4j_tpu_torch.parallel.compress import (
                enable_grad_compression, ensure_compress_state)
            enable_grad_compression(m, scheme)
            ensure_compress_state(m)
        if self.tensor_parallel:
            self._check_tensor_parallel()
            tp = TensorParallel(self.mesh, m.params)
            self._tp = m._tp = tp
            self._set_trees(tp.shard)
        self._placed = True

    def _check_tensor_parallel(self):
        """The step's per-layer rules that read a whole leaf have no
        counterpart on a slice: refused by name."""
        from deeplearning4j_tpu_torch.nn.conf.layers import reg_object
        for k, layer in self._layer_items():
            for knob, value in (("gradient_normalization",
                                 getattr(layer, "gradient_normalization", None)),
                                ("constraints", reg_object(layer, "constraints"))):
                if value not in (None, (), "none", "None"):
                    raise NotImplementedError(
                        f"tensor_parallel=True: layer {k!r} sets {knob}, which reads "
                        "whole leaves; a rank holds slices of the sharded ones")

    def _layer_items(self):
        confs = self.model._layer_confs
        return confs.items() if isinstance(confs, dict) else enumerate(confs)

    def _set_trees(self, fn):
        """``fn`` (``TensorParallel.shard`` or ``.gather``) over the model's
        parameters, updater slots and compression residual."""
        m, tp = self.model, self._tp
        m.params = fn(m.params)
        if m.opt_state is not None:
            m.opt_state = _map_opt_state(m.opt_state,
                                         lambda t, k: fn(t, axes=tp.axes[k]))
        cs = getattr(m, "compress_state", None)
        if cs is not None and cs.get("residual") is not None:
            m.compress_state = dict(cs, residual=fn(cs["residual"]))

    def unshard(self):
        """Under tensor parallelism: gather the model's parameters,
        updater slots and compression residual whole on every rank and
        leave the placement (the next step places again). A no-op
        otherwise."""
        if self._tp is not None:
            self._set_trees(self._tp.gather)
            self.model._tp = self._tp = None
            self._placed = False

    @contextlib.contextmanager
    def _whole(self):
        """The model with whole leaves inside (a checkpoint, a forward),
        its slices again after."""
        if self._tp is None:
            yield
            return
        m = self.model
        saved = m.params, m.opt_state, getattr(m, "compress_state", None)
        self._set_trees(self._tp.gather)
        m._tp = None
        try:
            yield
        finally:
            m.params, m.opt_state, m.compress_state = saved
            m._tp = self._tp

    def _checkpoint(self, manager, seen=None):
        """``manager``'s ``step_end`` after a step (``seen`` batches into
        the epoch), or its ``epoch_end`` with ``seen`` None; under tensor
        parallelism the leaves are gathered whole only for a save."""
        due = manager.save_due(self.model, epoch_end=seen is None)
        with self._whole() if due else contextlib.nullcontext():
            if seen is None:
                manager.epoch_end(self.model, due=due)
            else:
                manager.step_end(self.model, batch_in_epoch=seen, due=due)

    def _epoch_end(self, checkpoint_manager):
        """The listeners' ``on_epoch_end`` on whole leaves, the epoch count,
        then the manager's ``epoch_end``."""
        if self.model.listeners:
            with self._whole():
                for listener in self.model.listeners:
                    listener.on_epoch_end(self.model)
        self.model.epoch += 1
        if checkpoint_manager is not None:
            self._checkpoint(checkpoint_manager)

    def _local_rows(self, ds):
        """This rank's contiguous rows of a global batch."""
        n = _num_examples(ds)
        dp = self.data_size
        if n % dp:
            raise ValueError(f"Global batch {n} not divisible by data-parallel size {dp}")
        if dp == 1:
            return ds
        k = n // dp
        i = self.mesh.data_index
        return _rows(ds, slice(i * k, (i + 1) * k))

    def _shard_dataset(self, ds):
        """This rank's rows of a global batch (host or device arrays; the
        network moves them to its device); a batch prefetch staged is
        already this rank's."""
        if getattr(ds, "_staged_local", False):
            return ds
        return self._local_rows(ds)

    def _standard(self) -> bool:
        from deeplearning4j_tpu_torch.nn.training import is_sgd_family
        # a graph configuration has no optimization_algo: it always steps
        return is_sgd_family(getattr(self.model.conf, "optimization_algo",
                                     "stochastic_gradient_descent"))

    def _model_fit_batch(self, local):
        """One step on this rank's rows without the model's own epoch
        side effects, inside the data group. The SGD family (tBPTT
        windows included) goes through the network's batch path; a solver
        configuration through ``model.fit`` with the epoch hooks
        suppressed, at one rank only (the solvers' line searches read the
        loss on the host and take no collective)."""
        m = self.model
        with data_parallel.data_group(self.mesh.data_group, self.data_size):
            if self._standard():
                m._fit_batch(local)
                return
            if self.data_size > 1:
                raise ValueError(
                    f"{m.conf.optimization_algo} (a full-batch solver) trains at one "
                    "rank only: its line search takes no collective")
            saved_listeners, epoch0 = m.listeners, m.epoch
            m.listeners = [_EpochHooksSuppressed(x) for x in saved_listeners]
            try:
                m.fit(local)
            finally:
                m.listeners = saved_listeners
                m.epoch = epoch0

    def _is_ragged(self, ds) -> bool:
        """Whether this global batch cannot split evenly over the ranks."""
        return bool(_num_examples(ds) % self.data_size)

    def fit_batch(self, ds, drop_ragged: bool = False) -> bool:
        """Train on ONE global batch (this rank's rows of it); returns
        whether it trained. ``drop_ragged`` drops a batch that does not
        divide the data-parallel size instead of raising."""
        self._place_params()
        staged = getattr(ds, "_staged_local", False)
        if not staged and self._is_ragged(ds) and drop_ragged:
            if not self._warned_ragged:
                log.warning(
                    "Dropping ragged batch of %d examples (global batch must divide "
                    "data-parallel size %d)", _num_examples(ds), self.data_size)
                self._warned_ragged = True
            return False
        if self.stats is None:
            self._model_fit_batch(self._shard_dataset(ds))
        else:
            with self.stats.time("data_placement"):
                sharded = self._shard_dataset(ds)
            with self.stats.time("train_dispatch"):
                self._model_fit_batch(sharded)
            self.stats.examples += _num_examples(sharded)
            self.stats.minibatches += 1
        return True

    # ---- training (reference ParallelWrapper.fit dispatch loop :210) ----
    def fit(self, data, num_epochs: int = 1, prefetch: bool = False,
            checkpoint_manager=None):
        """Train ``num_epochs`` over a global iterator (or one DataSet).
        ``prefetch=True`` stages this rank's rows of batch N+1 onto the
        device while step N runs (``perf/prefetch.py``).
        ``checkpoint_manager`` checkpoints per its triggers and resumes a
        restored model at the exact step (``num_epochs`` is then the run's
        total), as ``MultiLayerNetwork.fit``."""
        from deeplearning4j_tpu_torch.checkpoint.manager import (resume_plan,
                                                                 skip_consumed_batches)
        self._place_params()
        explicit_single = isinstance(data, (DataSet, MultiDataSet))
        if explicit_single:
            data = [data]
        epochs_to_run, skip = resume_plan(self.model, num_epochs)
        if hasattr(data, "bind_epoch"):
            data.bind_epoch(lambda: self.model.epoch)
        for _ in range(epochs_to_run):
            for listener in self.model.listeners:
                listener.on_epoch_start(self.model)
            trained = 0
            seen = skip
            resumed_mid_epoch = skip > 0
            stream = skip_consumed_batches(data, skip)
            if prefetch and not explicit_single:
                stream = self._prefetched(stream)
            for ds in stream:
                seen += 1
                if self.fit_batch(ds, drop_ragged=not explicit_single):
                    trained += 1
                    if checkpoint_manager is not None:
                        self._checkpoint(checkpoint_manager, seen)
            skip = 0
            if seen == 0:
                raise ValueError(
                    "No batches this epoch — the data iterable is empty or a one-shot "
                    "generator exhausted by a previous epoch; pass a re-iterable "
                    "DataSetIterator")
            if trained == 0 and not resumed_mid_epoch:
                raise ValueError(
                    "Every batch this epoch was dropped as ragged — the batch size "
                    f"never divides the data-parallel size {self.data_size}; pick a "
                    "divisible batch")
            self._epoch_end(checkpoint_manager)
            if self.stats is not None:
                with self.stats.time("epoch_sync"):
                    self._sync()
        self.unshard()
        return self

    def _prefetched(self, stream):
        """``stream`` with this rank's rows of each batch staged onto the
        device one batch ahead; a ragged batch passes through whole (on
        the host), so the drop-or-raise decision sees its global size."""
        from collections import deque

        from deeplearning4j_tpu_torch.perf.prefetch import DevicePrefetchIterator
        staged = deque()

        def rows():
            for ds in stream:
                ragged = self._is_ragged(ds)
                staged.append(not ragged)
                yield ds if ragged else self._stage_local_batch(ds)

        for ds in DevicePrefetchIterator(rows(), device=self.model.device):
            if staged.popleft():
                ds._staged_local = True
            yield ds

    def _stage_local_batch(self, ds):
        """The host side of prefetch staging: this rank's rows of the batch
        (the step does not slice a staged batch again)."""
        return self._shard_dataset(ds)

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def output(self, x):
        """The network's output on ``x`` (every rank computes the same
        whole answer, from whole leaves under tensor parallelism)."""
        if self.model.params is None:
            self.model.init()
        with self._whole():
            return self.model.output(x)


class ClusterTrainer(ParallelWrapper):
    """Multi-process training: one process a rank, each feeding its rows
    of the global batch (reference: the Spark training masters).

    Usage (per process)::

        ClusterTrainer.initialize("tcp://host0:29500", num_processes=4,
                                  process_id=rank)
        net = ...build on this rank's device...
        trainer = ClusterTrainer(net)           # mesh over every rank
        trainer.fit_local_shard(local_iterator) # this rank's data
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # whether this epoch's first batch passed the equal-shard check
        self._epoch_shards_verified = False

    @staticmethod
    def initialize(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, backend: Optional[str] = None,
                   timeout_s: float = 300.0):
        """``torch.distributed.init_process_group`` over
        ``coordinator_address`` (``host:port`` or ``tcp://host:port``; rank
        0 hosts the store there), NCCL when a card is present and gloo
        otherwise unless ``backend`` says. A no-op at one process."""
        if num_processes is None or num_processes <= 1:
            return
        import datetime
        import torch.distributed as dist
        addr = str(coordinator_address)
        if "://" not in addr:
            addr = "tcp://" + addr
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                                rank=int(process_id),
                                timeout=datetime.timedelta(seconds=float(timeout_s)))

    # ---- per-rank batches ----
    def _verify_equal_local_shards(self, n_local: int, _gather=None):
        """Every rank must feed the same local batch size: one all-gather
        of the local count at the first batch of each epoch, on every rank
        at the same batch (an aligned collective; a cache keyed by the
        value would make it conditional and deadlock in exactly the
        unequal case), raises a named UnequalShardError on every rank.
        ``_gather`` is injectable for tests."""
        if self._epoch_shards_verified:
            return
        if _gather is None:
            d = _dist()
            if d is None or d.get_world_size() == 1:
                self._epoch_shards_verified = True
                return

            def _gather(n):
                dev = (self.model.device if d.get_backend() == "nccl"
                       else torch.device("cpu"))
                t = torch.tensor([n], dtype=torch.int64, device=dev)
                out = [torch.zeros_like(t) for _ in range(d.get_world_size())]
                d.all_gather(out, t)
                return [int(o.item()) for o in out]
        from deeplearning4j_tpu_torch.parallel.sharding import check_equal_local_shards
        check_equal_local_shards(_gather(n_local))
        self._epoch_shards_verified = True

    def _shard_dataset(self, ds):
        """In cluster mode the incoming batch is this rank's LOCAL rows:
        it is checked (equal shards) and kept as it is."""
        n_local = _num_examples(ds)
        dp = self.data_size
        n_global = n_local * _process_count()
        if n_global % dp:
            raise ValueError(f"Global batch {n_global} (local {n_local} x "
                             f"{_process_count()} processes) not divisible by "
                             f"data-parallel size {dp}")
        self._verify_equal_local_shards(n_local)
        return ds

    def _is_ragged(self, ds) -> bool:
        """Rank-local: local rows against this rank's share of the data
        axis (one device a rank, so a share of one). With equal shards the
        decision is the same on every rank, so no rank drops a batch its
        peers train; unequal shards raise UnequalShardError instead."""
        local_share = max(1, self.data_size // max(1, _process_count()))
        return bool(_num_examples(ds) % local_share)

    def fit(self, data, num_epochs: int = 1, prefetch: bool = False,
            checkpoint_manager=None):
        """Train from an ORDINARY global iterator: every rank walks the same
        iterator and keeps its row shard of each batch
        (``parallel/sharding.py``). ``checkpoint_manager``: rank 0 writes,
        the others barrier under the watchdog's deadline."""
        from deeplearning4j_tpu_torch.parallel.sharding import shard_iterator
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        local = shard_iterator(data) if _process_count() > 1 else data
        return self.fit_local_shard(local, num_epochs=num_epochs, prefetch=prefetch,
                                    checkpoint_manager=checkpoint_manager)

    def score_local_shard(self, ds) -> float:
        """The loss over a validation batch given as per-rank rows: each
        rank's loss, averaged over the ranks (the equal shards make it the
        global batch's)."""
        self._place_params()
        local = self._shard_dataset(ds)
        with data_parallel.data_group(self.mesh.data_group, self.data_size), self._whole():
            s = torch.tensor(float(self.model.score_dataset(local)), dtype=torch.float64)
            if self.data_size > 1:
                d = _dist()
                if d.get_backend() == "nccl":
                    s = s.to(self.model.device)
                d.all_reduce(s, group=self.mesh.data_group)
                s = s / self.data_size
            return float(s)

    def fit_local_shard(self, data, num_epochs: int = 1,
                        collective_timeout_s: Optional[float] = None,
                        watchdog_every: int = 10, prefetch: bool = False,
                        checkpoint_manager=None):
        """Feed per-rank local batches.

        ``collective_timeout_s`` arms a CollectiveWatchdog: each step runs
        under its deadline (a gloo collective blocks the calling thread, so
        the deadline wraps the whole call), and every ``watchdog_every``
        steps the host waits for the device under it, so a dead peer
        raises a diagnostic CollectiveTimeoutError instead of blocking
        forever. ``prefetch=True`` stages batch N+1 while step N runs.
        ``checkpoint_manager`` checkpoints after each step per its
        triggers (rank 0 writes, peers barrier) and resumes a restored
        model at the exact step."""
        from deeplearning4j_tpu_torch.checkpoint.manager import (resume_plan,
                                                                 skip_consumed_batches)
        from deeplearning4j_tpu_torch.obs.trace import get_tracer
        wd = None
        if collective_timeout_s is not None:
            from deeplearning4j_tpu_torch.parallel.watchdog import CollectiveWatchdog
            wd = CollectiveWatchdog(timeout_s=collective_timeout_s)
        self._place_params()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        tracer = get_tracer()
        epochs_to_run, skip = resume_plan(self.model, num_epochs)
        if hasattr(data, "bind_epoch"):
            data.bind_epoch(lambda: self.model.epoch)
        step_no = 0
        for _ in range(epochs_to_run):
            # every rank re-verifies at its first batch: an aligned
            # once-an-epoch collective
            self._epoch_shards_verified = False
            for listener in self.model.listeners:
                listener.on_epoch_start(self.model)
            seen = skip
            stream = skip_consumed_batches(data, skip)
            if prefetch:
                stream = self._prefetched(stream)
            stream = tracer.wrap_iter(stream, "train.data_wait")
            for ds in stream:
                def one_step(d=ds):
                    if self.stats is None:
                        self._model_fit_batch(self._shard_dataset(d))
                    else:
                        with self.stats.time("data_placement"):
                            local = self._shard_dataset(d)
                        with self.stats.time("train_dispatch"):
                            self._model_fit_batch(local)
                        self.stats.examples += _num_examples(d)
                        self.stats.minibatches += 1

                if tracer.enabled:
                    # both spans in ONE watchdog call: the traced path pays
                    # the same one worker thread a step, and the device wait
                    # stays under the deadline
                    def traced_step(n=step_no):
                        with tracer.span("train.step_host", step=n):
                            one_step()
                        with tracer.span("train.step_device", step=n):
                            self._sync()
                    step = traced_step
                    what = f"cluster step {step_no + 1} dispatch+sync"
                else:
                    step, what = one_step, f"cluster step {step_no + 1} dispatch"
                if wd is None:
                    step()
                else:
                    wd.call(step, what=what)
                step_no += 1
                seen += 1
                if wd is not None and step_no % max(1, watchdog_every) == 0:
                    wd.sync(self.model.params, what=f"cluster step {step_no}")
                if checkpoint_manager is not None:
                    self._checkpoint(checkpoint_manager, seen)
            skip = 0
            if seen == 0:
                raise ValueError(
                    "No batches this epoch — the data iterable is empty or a one-shot "
                    "generator exhausted by a previous epoch; pass a re-iterable "
                    "DataSetIterator")
            self._epoch_end(checkpoint_manager)
            if self.stats is not None:
                with self.stats.time("epoch_sync"):
                    self._sync()
        if wd is not None:
            # tail steps after the last every-N wait stay under the deadline
            wd.sync(self.model.params, what=f"epoch end (step {step_no})")
        self.unshard()
        return self


from deeplearning4j_tpu_torch.earlystopping.trainer import EarlyStoppingTrainer  # noqa: E402


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel training (reference
    ``EarlyStoppingParallelTrainer.java:44``): each training batch goes
    through a ParallelWrapper (or, ``cluster=True``, a ClusterTrainer fed
    per-rank rows, whose validation score is the ranks' mean when no
    ``score_calculator`` is given); savers and conditions see what the
    single-process EarlyStoppingTrainer gives them."""

    def __init__(self, config, model, train_data, validation_data=None,
                 score_calculator=None, mesh=None, tensor_parallel: bool = False,
                 cluster: bool = False, checkpoint_manager=None):
        trainer_holder = []
        if cluster and score_calculator is None and validation_data is not None:
            def score_calculator(m):
                total, n = 0.0, 0
                for ds in validation_data:
                    total += trainer_holder[0].score_local_shard(ds) * _num_examples(ds)
                    n += _num_examples(ds)
                return total / max(n, 1)
        super().__init__(config, model, train_data, validation_data, score_calculator,
                         checkpoint_manager=checkpoint_manager)
        cls = ClusterTrainer if cluster else ParallelWrapper
        self.wrapper = cls(model, mesh=mesh, tensor_parallel=tensor_parallel)
        trainer_holder.append(self.wrapper)

    def _fit_batch(self, ds) -> bool:
        # per-batch path: no epoch-listener double fire, ragged tails dropped;
        # the model whole again for the scoring and savers between batches
        trained = self.wrapper.fit_batch(ds, drop_ragged=True)
        self.wrapper.unshard()
        return trained
