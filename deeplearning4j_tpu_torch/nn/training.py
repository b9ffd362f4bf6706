"""The training step that ``ComputationGraph`` and ``MultiLayerNetwork``
share, over their parameter trees: a dict keyed by vertex name in the
graph, a list indexed by layer in the sequential network.

A network class mixes in :class:`TrainStep`, calls ``_init_training`` from
its constructor with its layers (in the same dict or list form), and gives
``_loss_fn(params, state, inputs, labels, rng, *masks) -> (loss, new
state)``; a truncated-BPTT window passes ``carries=`` through the step and
gets ``(loss, new state, new carries)`` back, the new carries returned by
``_train_step``. The step does what the JAX package's jitted step does,
eagerly:

- ``_cast`` casts the float32 master parameters to the compute dtype
  (``conf.dtype``) inside autograd, so gradients land on the masters in
  float32;
- ``_loss_and_grads`` takes gradients with ``torch.autograd.grad`` of
  every leaf of a layer whose updater is not ``NoOp`` (zeros for a leaf the
  loss does not reach). A frozen layer's (``NoOp``: transfer learning)
  leaves are not handed to autograd and get zero gradients, so no backward
  runs for a frozen prefix, as XLA drops the frozen trunk's backward from
  the JAX step; a frozen layer between trainable ones still passes
  gradients to the layers before it;
- ``_apply_updates`` sends each layer's gradient tree through its gradient
  normalization and its updater (``optimize/fused_update.py``:
  ``bucketed_apply``, the small leaves of every layer that share an
  updater in one foreach sequence, the rest per tensor, in place on the
  masters and the slots), then applies every layer's ``constraints``;
- under tensor parallelism (``parallel/trainer.py``) ``_tp`` holds the
  placement and the parameters are this rank's slices: ``_loss_and_grads``
  gathers them whole through a differentiable all-gather and takes the
  slices' gradients, and the compression encodes the whole gradient
  (gathered with its residual) and keeps this rank's slices;
- ``_reduce_and_compress`` sits between the gradients and the updaters:
  while a data group is active (``nn/data_parallel.py``, entered by
  ``parallel/trainer.py`` over a ``torch.distributed`` group) it
  averages every trainable gradient leaf (one flat bucket a dtype) and
  the loss over the ranks, then runs the attached gradient compression
  (``grad_compression``, ``parallel/compress.py``) on the result, its
  error-feedback state in ``compress_state``: the JAX step's order;
- ``_commit_state`` writes the new running stats into the state in place;
- dropout draws from a ``torch.Generator`` seeded with the init seed + 1;
- with ``set_augmentation``, the train step augments its 4-D (NHWC)
  inputs on their device (``datasets/augment.py``) with draws from a second
  ``torch.Generator`` on the network's device, seeded with the init seed +
  2; evaluation and scoring paths do not augment. Both generators' states
  travel in a checkpoint (``torchGeneratorState.npz``), so resume replays
  both streams bitwise;
- each listener's ``iteration_done(net, iteration, epoch)`` runs after the
  step's update, before ``iteration`` advances, as the JAX package calls
  it; where a listener sets ``needs_features`` (the activation sampler,
  ``optimize/listeners.py::ConvolutionalIterationListener``),
  ``_last_features`` keeps a copy of the batch's first example (one per
  network input in a graph), a launch and a small allocation a step.

``_fit_epochs`` is the epoch loop both networks' ``fit`` share, in the
JAX ``fit``'s order: data with ``bind_epoch`` (a ``ShardedReader``) follows
the network's epoch counter; ``bucket_policy`` pads every batch to its
bucket above the resume skip (``perf/bucketing.py``); each epoch's stream
skips the batches a restored checkpoint had consumed, by seeking where the
data has ``iter_from`` (``checkpoint/manager.py::skip_consumed_batches``);
``prefetch=True`` stages each batch onto the device under
``perf/prefetch.py::DevicePrefetchIterator`` (below the skip's result, so
skipped batches are never copied); and a ``train.data_wait`` span times
each wait for the next batch, above the prefetch (what the step loop
really waits for). Around it: the listeners' ``on_epoch_start`` /
``on_epoch_end``, and with a ``checkpoint_manager`` its ``step_end`` after
every batch and ``epoch_end`` after every epoch. A network that
``restore_latest`` returned carries a resume marker, which the next
``fit`` consumes: ``num_epochs`` is then the run's total
(``checkpoint/manager.py::resume_plan``).

Listeners are duck-typed, as in the JAX package: any object with
``iteration_done``, ``on_epoch_start`` and ``on_epoch_end``
(``checkpoint.FaultInjector`` is one).

Every walk goes to every depth (``nn/tree.py``), so the attention layers'
``q``/``k``/``v``/``o`` groups train like flat parameters.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import data_parallel
from deeplearning4j_tpu_torch.nn.conf.layers import apply_constraints
from deeplearning4j_tpu_torch.nn.tree import leaf_grads, tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.fused_update import bucketed_apply
from deeplearning4j_tpu_torch.optimize.updaters import NoOp, gradient_normalization

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}
_SGD_FAMILY = ("sgd", "stochastic_gradient_descent")


def normalize_optimization_algo(name) -> str:
    """The lowercase-underscore form of an optimization-algorithm name
    ("Stochastic Gradient Descent", "SGD" and "sgd" alike)."""
    return (str(name or "stochastic_gradient_descent").strip().lower()
            .replace("-", "_").replace(" ", "_"))


def is_sgd_family(algo_or_conf) -> bool:
    """Whether a configuration (or an algorithm name) trains by minibatch
    steps rather than through a full-batch solver (``optimize/solvers.py``)."""
    algo = getattr(algo_or_conf, "optimization_algo", algo_or_conf)
    return normalize_optimization_algo(algo) in _SGD_FAMILY


def to_float32(preout):
    """An output layer's pre-activation, a tensor or a dict of them
    (CenterLoss, YOLO), with every bf16/f16 leaf in float32: the loss math
    runs in float32."""
    return tree_map(lambda v: v.float() if v.dtype in (torch.bfloat16, torch.float16)
                    else v, preout)


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _keyed(tree, fn):
    """``fn(key, value)`` for each entry, in a dict or list as ``tree`` is."""
    if isinstance(tree, dict):
        return {k: fn(k, v) for k, v in tree.items()}
    return [fn(i, v) for i, v in enumerate(tree)]


class TrainStep:
    """The shared step; see the module docstring for what a network gives."""

    def _init_training(self, layers):
        conf = self.conf
        if conf.dtype not in DTYPES:
            raise ValueError(f"unknown dtype '{conf.dtype}' (known: {sorted(DTYPES)})")
        self._dtype = DTYPES[conf.dtype]
        self._layer_confs = layers
        self._updaters = _keyed(layers, lambda _, layer: getattr(layer, "updater", None)
                                or conf.updater)
        self._gnorms = _keyed(layers, lambda _, layer: gradient_normalization(
            getattr(layer, "gradient_normalization", None),
            getattr(layer, "gradient_normalization_threshold", 1.0)))
        self._frozen = {k for k, u in _items(self._updaters) if isinstance(u, NoOp)}
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        self.last_batch_size: Optional[int] = None
        self._tp = None  # parallel/mesh.py TensorParallel while sliced
        self.grad_compression = None  # parallel/compress.py scheme
        self.compress_state = None
        self._score = None
        self._gen: Optional[torch.Generator] = None  # dropout stream
        self._aug_gen: Optional[torch.Generator] = None  # augmentation stream
        self.augmentation = None
        self.listeners: list = []
        self._last_features = None  # the last fit batch's first example
        # set by CheckpointManager.restore_latest and consumed by the next
        # fit (exact-step resume); _restored_from is provenance only
        self._resume_state = None
        self._restored_from = None
        # dispatch/compile counters of the train, output and score calls
        # (perf/compile_watch.py); a compile is a call at a new signature
        from deeplearning4j_tpu_torch.perf.compile_watch import CompileWatch
        self.compile_watch = CompileWatch(type(self).__name__)
        self._watched_fns: dict = {}

    def _watched(self, key: str, fn):
        """``fn`` wrapped by this network's CompileWatch under ``key``, one
        wrapper a key (it keeps the signatures seen)."""
        w = self._watched_fns.get(key)
        if w is None:
            w = self._watched_fns[key] = self.compile_watch.wrap(fn, key)
        return w

    def _validate(self, validate: Optional[bool]):
        """``init``'s first step: ``conf.validate()`` unless ``validate`` is
        False, or None with ``DL4J_TPU_VALIDATE=0`` in the environment."""
        if validate is None:
            validate = os.environ.get("DL4J_TPU_VALIDATE", "1") != "0"
        if validate:
            self.conf.validate()

    def _seed_dropout(self, seed: Optional[int] = None):
        """Seed the dropout (seed + 1) and augmentation (seed + 2)
        generators, on the network's device."""
        base = self.conf.seed if seed is None else int(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(base + 1)
        self._aug_gen = torch.Generator(device=self.device)
        self._aug_gen.manual_seed(base + 2)

    def set_augmentation(self, augmentation):
        """Enable on-device augmentation (a ``datasets.augment.
        ImageAugmentation``, or None to disable) in the train step; see the
        module docstring."""
        self.augmentation = augmentation
        return self

    def _augment(self, x, rng):
        """``x`` augmented when this is a train step (``rng`` set) and an
        augmentation is on, else ``x``."""
        if self.augmentation is None or rng is None:
            return x
        return self.augmentation.apply(x, self._aug_gen)

    def _reset_updaters(self):
        """Updater state anew for the current parameters."""
        self.opt_state = _keyed(self._updaters, lambda k, u: u.init_state(self.params[k]))
        if self._gen is None:
            self._seed_dropout()

    def num_params(self) -> int:
        return 0 if self.params is None else sum(t.numel() for t in tree_leaves(self.params))

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    def score(self) -> Optional[float]:
        """Most recent minibatch score (reference Model.score())."""
        return None if self._score is None else float(self._score)

    def _cast(self, params):
        """``params`` in the compute dtype (float leaves only)."""
        cdt = self._dtype
        if cdt == torch.float32:
            return params
        return tree_map(lambda v: v.to(cdt) if v.is_floating_point() else v, params)

    def _loss_and_grads(self, *batch, **kw):
        """(loss, gradient tree, new state[, new carries]) at the current
        parameters; ``batch`` and ``kw`` are what ``_loss_fn`` takes after
        the parameters and state."""
        frozen = self._frozen
        leaves = _keyed(self.params, lambda k, p: p if k in frozen else
                        tree_map(lambda v: v.detach().requires_grad_(True), p))
        tp = self._tp
        whole = leaves if tp is None else tp.gather(leaves, differentiable=True)
        loss, *aux = self._loss_fn(whole, self.state, *batch, **kw)
        live = leaf_grads(loss, {k: p for k, p in _items(leaves) if k not in frozen})
        grads = _keyed(leaves, lambda k, p: live[k] if k in live
                       else tree_map(torch.zeros_like, p))
        return (loss.detach(), grads, *aux)

    def _reduce_and_compress(self, loss, grads):
        """Between the gradients and the updaters: in a data group
        (``nn/data_parallel.py``) the mean over the ranks of every trainable
        gradient leaf and of the loss, then the gradient compression
        (``parallel/compress.py``) when a scheme is attached, the JAX
        step's order (its ``comp.apply`` sees GSPMD's global gradient)."""
        if data_parallel.reducing():
            loss = data_parallel.mean_gradients(
                [g for k, t in _items(grads) if k not in self._frozen
                 for g in tree_leaves(t)], loss)
        if self.grad_compression is not None:
            if self.compress_state is None:
                self.compress_state = self.grad_compression.init_state(self.params)
            tp = self._tp
            if tp is None:
                grads, self.compress_state = self.grad_compression.apply(grads,
                                                                         self.compress_state)
            else:
                # the schemes' statistics (tau's nonzero count, a leaf's top
                # k, scale or means) read whole leaves: encode the whole
                # gradient on every rank of the model group, keep the slices
                st = self.compress_state
                res = st["residual"]
                whole, st = self.grad_compression.apply(
                    tp.gather(grads), dict(st, residual=None if res is None else tp.gather(res)))
                grads = tp.shard(whole)
                if st["residual"] is not None:
                    st = dict(st, residual=tp.shard(st["residual"]))
                self.compress_state = st
        return loss, grads

    def _apply_updates(self, grads):
        with torch.no_grad():
            bucketed_apply([k for k, _ in _items(self._updaters)], self._updaters,
                           self._gnorms, self.params, grads, self.opt_state)
            for k, _ in _items(self._updaters):
                apply_constraints(self._layer_confs[k], self.params[k])

    def _commit_state(self, new_state):
        with torch.no_grad():
            for k, st in _items(new_state):
                cur = self.state[k]
                for name, v in st.items():
                    if v is not cur[name]:
                        cur[name].copy_(v)

    def _train_step(self, inputs, labels, *masks, **kw):
        """One step on one batch: gradients, updates, state, score. Returns
        the new carries of a tBPTT window (``kw`` holds ``carries``), else
        None. Counted by ``compile_watch`` as ``train`` (``tbptt`` for a
        window)."""
        key = "tbptt" if kw.get("carries") is not None else "train"
        return self._watched(key, self._step)(inputs, labels, *masks, **kw)

    def _step(self, inputs, labels, *masks, **kw):
        """:meth:`_train_step` without the counting."""
        if self.opt_state is None:  # parameters assigned directly
            self._reset_updaters()
        loss, grads, new_state, *carries = self._loss_and_grads(inputs, labels, self._gen,
                                                                *masks, **kw)
        loss, grads = self._reduce_and_compress(loss, grads)
        self._apply_updates(grads)
        self._commit_state(new_state)
        self._score = loss
        if any(getattr(listener, "needs_features", False) for listener in self.listeners):
            self._last_features = ([x[:1].clone() for x in inputs] if isinstance(inputs, list)
                                   else inputs[:1].clone())
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration, self.epoch)
        self.iteration += 1
        return carries[0] if carries else None

    def _fit_epochs(self, data, num_epochs: int, checkpoint_manager, fit_batch,
                    bucket_policy=None, prefetch: bool = False):
        """The epoch loop of ``fit`` (the JAX package's, hooks included; see
        the module docstring): ``fit_batch(batch)`` for each batch of
        ``data``, which is iterated anew every epoch."""
        from deeplearning4j_tpu_torch.checkpoint.manager import (resume_plan,
                                                                 skip_consumed_batches)
        from deeplearning4j_tpu_torch.obs.trace import get_tracer
        epochs_to_run, skip = resume_plan(self, num_epochs)
        if hasattr(data, "bind_epoch"):
            # a sharded reader follows the network's epoch, so a restored
            # network replays the interrupted epoch's order
            data.bind_epoch(lambda: self.epoch)
        if bucket_policy is not None:
            from deeplearning4j_tpu_torch.perf.bucketing import (BucketPadDataSetIterator,
                                                                 BucketPolicy)
            data = BucketPadDataSetIterator(data, BucketPolicy() if bucket_policy is True
                                            else bucket_policy)
        tracer = get_tracer()
        for _ in range(epochs_to_run):
            for listener in self.listeners:
                listener.on_epoch_start(self)
            stream = skip_consumed_batches(data, skip)
            if prefetch:
                from deeplearning4j_tpu_torch.perf.prefetch import DevicePrefetchIterator
                stream = DevicePrefetchIterator(stream, device=self.device)
            stream = tracer.wrap_iter(stream, "train.data_wait")
            bi = skip
            for batch in stream:
                bi += 1
                fit_batch(batch)
                if checkpoint_manager is not None:
                    checkpoint_manager.step_end(self, batch_in_epoch=bi)
            skip = 0
            for listener in self.listeners:
                listener.on_epoch_end(self)
            self.epoch += 1
            if checkpoint_manager is not None:
                checkpoint_manager.epoch_end(self)
        return self

