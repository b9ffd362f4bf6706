"""MultiLayerNetwork — the sequential-stack network (counterpart of
``deeplearning4j_tpu/nn/multilayer.py``: ``init``, ``_forward`` with its
features mask and recurrent carries, ``fit``, ``fit_fused``, truncated BPTT
(``_fit_tbptt``, ``fit_tbptt_fused``), ``_fit_batch``, ``_loss_fn``,
``_regularization``, ``score``, ``score_dataset``, ``output``, ``predict``,
``feed_forward``, ``rnn_time_step`` and its stored state, ``evaluate`` /
``evaluate_regression``, and the serving decode tier's ``decode_step_fn`` /
``decode_prefill_fn`` / ``decode_vocab_size``).

Parameters are a list of per-layer dicts of tensors in the JAX package's
layouts (nested, for the attention layers' ``q``/``k``/``v``/``o``
groups), so ``interop.params_from_jax`` can hand over a JAX network's
weights leaf for leaf; ``state`` is the list of per-layer buffer dicts
(batch-norm running stats). Inputs are taken as float32, token ids
included: float32 holds every id below 2**24 exactly, and the embedding
layers cast them to long. PyTorch runs eagerly: there is no compiled
program per shape, and ``output`` returns a tensor on the network's device
without waiting for it.

One training step (``_fit_batch``) is the step of ``nn/training.py``,
which ``ComputationGraph`` shares: float32 masters cast to the compute
dtype (``conf.dtype``: float32, bfloat16, float16 or float64) inside
autograd; the features cast too, unless the first layer takes ids (which
bf16 would round past 256); the output layer's pre-activation in float32
for the loss, which is its score over the labels mask or else the features
mask that survives to the output, plus l1/l2; each layer's gradients
through its gradient normalization and its updater, added to the masters
in place; running stats updated in place; dropout drawn from a
``torch.Generator`` seeded with ``conf.seed + 1`` (or ``init``'s seed
+ 1).

``fit_fused`` (an XLA scan over K stacked batches there) is the same step
in a Python loop.

Truncated BPTT (``backprop_type="tbptt"``, reference doTruncatedBPTT):
``fit`` cuts a batch whose input has a time axis longer than
``tbptt_fwd_length`` into windows of that length (the last one ragged) and
takes one updater step a window. Each recurrent layer's carry (h, c) goes
from one window into the next detached, so gradients stop at the window
boundary, as the JAX package's carries enter each window's jitted step as
constants. ``fit_tbptt_fused`` (one scan over the windows there) is the
same loop. ``rnn_time_step`` carries the same state across calls.

``fit`` runs the epoch loop of ``nn/training.py::TrainStep._fit_epochs``:
listeners (duck-typed: ``iteration_done`` after each updater step, each
tBPTT window included, and ``on_epoch_start`` / ``on_epoch_end``), a
``checkpoint_manager`` (``checkpoint/manager.py``), whose resume marker on a
restored network makes ``num_epochs`` the run's total and skips (or seeks
past) the batches already consumed, ``bucket_policy``, ``prefetch`` and the
``train.data_wait`` span. ``set_augmentation`` augments the features in
the train step (not in a tBPTT window, as in the JAX package).
``fit_fused`` and ``fit_tbptt_fused`` call the listeners once a step as
well, where the JAX package's one scan calls them once.

``pretrain`` / ``pretrain_layer`` train the pretrainable layers
(AutoEncoder, RBM, VariationalAutoencoder) greedily on their unsupervised
losses. Layers' ``weight_noise`` applies in every training forward,
``constraints`` after every updater step, ``remat`` through
``torch.utils.checkpoint`` (``perf/fusion.py``).

An ``optimization_algo`` outside the SGD family (``lbfgs``,
``conjugate_gradient``, ``line_gradient_descent``) makes ``fit`` run
``optimize/solvers.py``'s ``Solver(optimization_algo)``, with its
defaults, on each batch as one full batch, with the epoch listeners, the
resume skip and the checkpoint hooks; ``bucket_policy`` and ``prefetch``
do not apply there. ``init`` validates
the configuration first (``conf.validate()``, ``analysis/validation.py``)
unless ``validate=False`` or ``DL4J_TPU_VALIDATE=0``.

With ``grad_compression`` set (``parallel.enable_grad_compression``),
every step of ``fit``, ``fit_fused`` and the tBPTT windows compresses its
gradients with error feedback (``nn/training.py``); inside a
``parallel.ClusterTrainer`` step the gradients are first averaged over the
data group.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import (apply_constraints, apply_layer,
                                                     dropout_input, noisy_params,
                                                     regularization_penalty)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.normalization import LOW_PRECISION
from deeplearning4j_tpu_torch.nn.training import TrainStep, is_sgd_family, to_float32
from deeplearning4j_tpu_torch.nn.tree import leaf_grads, tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.fused_update import bucketed_apply

log = logging.getLogger(__name__)


def _copy_tree(tree, device):
    """A copy of a (nested) dict of tensors on ``device``."""
    return tree_map(lambda v: v.to(device, copy=True), tree)


class MultiLayerNetwork(TrainStep):
    """Sequential network. ``device`` follows the port's device rule:
    ``cuda`` unless the caller passes ``device="cpu"``."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.device = resolve_device(device)
        self.conf = conf
        self.layers = conf.wired_layers()
        self._pre = conf.resolved_preprocessors()
        if not self.layers:
            raise ValueError("Empty layer list")
        self._takes_ids = getattr(self.layers[0], "takes_ids", False)
        # whether each layer's output keeps the time axis a features mask
        # applies to; the mask is dropped after a layer that collapses time
        self._mask_survives = [layer.output_type(it).kind in ("rnn", "cnn1d")
                               for layer, it in zip(self.layers,
                                                    conf.layer_input_types())]
        self._init_training(self.layers)
        self.params: Optional[List[dict]] = None
        self.state: List[dict] = [{} for _ in self.layers]
        self._rnn_carries: Optional[list] = None  # rnn_time_step's stored state

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None,
             validate: Optional[bool] = None) -> "MultiLayerNetwork":
        """Draw every layer's parameters from one ``torch.Generator`` on the
        network's device, seeded with ``conf.seed`` (or ``seed``); dropout
        draws from a second one (seed + 1). Runs ``conf.validate()`` first,
        so a broken configuration fails here with a layer-named message;
        opt out with ``validate=False`` or ``DL4J_TPU_VALIDATE=0``."""
        self._validate(validate)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.conf.seed if seed is None else int(seed))
        self._seed_dropout(seed)
        types = self.conf.layer_input_types()
        ps = [layer.init(gen, it, self.device)
              for layer, it in zip(self.layers, types)]
        return self.set_params([p for p, _ in ps], [s for _, s in ps])

    def set_params(self, params: List[dict], state: Optional[List[dict]] = None):
        """Take these parameters (and state), e.g. from ``interop``; updater
        state starts anew."""
        self.params = params
        if state is not None:
            self.state = state
        self._reset_updaters()
        return self

    def to(self, device) -> "MultiLayerNetwork":
        """A new network on ``device`` with copies of these parameters."""
        out = MultiLayerNetwork(self.conf, device)
        out.params, out.state = ([_copy_tree(p, out.device) for p in tree]
                                 for tree in (self.params, self.state))
        return out

    # --------------------------------------------------------------- forward
    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _as_labels(self, y) -> torch.Tensor:
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
            if y.dtype == np.float64:  # the JAX package computes it in float32
                y = y.astype(np.float32)
        return torch.as_tensor(y, device=self.device)

    def _forward(self, params, state, x, train: bool, rng=None, mask=None, carries=None):
        """The forward pass: (every layer's activation, the output layer's
        pre-activation in float32 or None, new state, the features mask that
        survives to the output, new carries). ``mask`` (batch, time) reaches
        each layer while its input has a time axis. With ``carries`` (one
        per layer, ``{}`` where a layer has none) each recurrent layer that
        supports stateful use starts from its carry and returns its new one
        (tBPTT, ``rnn_time_step``); without, every layer starts from zero
        state and the new carries are all ``{}``."""
        params = self._cast(params)
        if self._dtype != torch.float32 and not self._takes_ids:
            x = x.to(self._dtype)
        acts, new_state, new_carries, preout = [], [], [], None
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if i in self._pre:
                x, mask = self._pre[i].apply(x, mask)
            carry = {}
            p_i = noisy_params(layer, params[i], rng, train)
            if i == last and layer.is_output_layer():
                preout = to_float32(layer.pre_output(p_i, dropout_input(x, layer.dropout,
                                                                        train, rng)))
                x = layer.output_activations(preout)
                new_state.append(state[i])
            elif (carries is not None and hasattr(layer, "apply_seq")
                  and getattr(layer, "supports_stateful", True)):
                x, carry = layer.apply_seq(p_i, carries[i],
                                           dropout_input(x, layer.dropout, train, rng),
                                           train=train, rng=None, mask=mask)
                new_state.append(state[i])
            else:
                x, st = apply_layer(layer, p_i, state[i], x, train=train, rng=rng,
                                    mask=mask)
                new_state.append(st)
            if not self._mask_survives[i]:
                mask = None
            acts.append(x)
            new_carries.append(carry)
        return acts, preout, new_state, mask, new_carries

    @torch.inference_mode()
    def output(self, x, features_mask=None) -> torch.Tensor:
        """Inference forward pass (reference MultiLayerNetwork.output, with
        the features mask of its 4-argument overload)."""
        if self.params is None:
            self.init()
        fm = None if features_mask is None else self._as_input(features_mask)
        return self._forward(self.params, self.state, self._as_input(x), False,
                             mask=fm)[0][-1]

    def predict(self, x, features_mask=None) -> np.ndarray:
        """Class indices (reference MultiLayerNetwork.predict)."""
        return self.output(x, features_mask).argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations (reference feedForward)."""
        return self._forward(self.params, self.state, self._as_input(x), False)[0]

    # ------------------------------------------------------------ train step
    def _regularization(self, params):
        """l1/l2 over every layer's regularizable paths and biases, nested
        ones included (reference calcL1/calcL2)."""
        total = 0.0
        for layer, p in zip(self.layers, params):
            total = total + regularization_penalty(layer, p)
        return total

    def _loss_fn(self, params, state, x, y, rng=None, fmask=None, lmask=None,
                 train: bool = True, carries=None):
        """(loss, new state): the output layer's score over the labels mask,
        or the surviving features mask, plus l1/l2. With ``carries`` (a tBPTT
        window), (loss, new state, new carries detached)."""
        out_layer = self.layers[-1]
        if not out_layer.is_output_layer():
            raise ValueError("Last layer must be an output/loss layer to fit()")
        if train and carries is None:
            x = self._augment(x, rng)
        _, preout, new_state, cur_mask, new_carries = self._forward(params, state, x, train,
                                                                    rng, fmask, carries)
        lm = lmask if lmask is not None else cur_mask
        if y.dtype in LOW_PRECISION:
            y = y.float()
        loss = out_layer.compute_score(y, preout, lm) + self._regularization(params)
        if carries is None:
            return loss, new_state
        return loss, new_state, tree_map(torch.Tensor.detach, new_carries)

    def _batch(self, ds: DataSet):
        fm, lm = ds.features_mask, ds.labels_mask
        return (self._as_input(ds.features), self._as_labels(ds.labels),
                None if fm is None else self._as_input(fm),
                None if lm is None else self._as_input(lm))

    def _fit_batch(self, ds: DataSet):
        x, y, fm, lm = self._batch(ds)
        if (self.conf.backprop_type == "tbptt" and self._has_time_axis(x)
                and x.shape[1] > self.conf.tbptt_fwd_length):
            self._fit_tbptt(x, y, fm, lm)
        else:
            self._train_step(x, y, fm, lm)
        self.last_batch_size = int(x.shape[0])

    # ------------------------------------------------- truncated BPTT / state
    def _has_time_axis(self, x) -> bool:
        """3-D sequences, or 2-D id sequences under an RNN input type."""
        it = self.conf.input_type
        return x.dim() == 3 or (x.dim() == 2 and it is not None and it.kind == "rnn"
                                and self.layers[0].input_kind() != "ff")

    def _zero_carries(self, batch: int) -> list:
        return [layer.init_carry(batch, self._dtype, self.device)
                if hasattr(layer, "init_carry") else {} for layer in self.layers]

    def _fit_tbptt(self, x, y, fm, lm):
        """One updater step a window of ``tbptt_fwd_length`` timesteps (the
        last window ragged), the carries going on detached."""
        length = self.conf.tbptt_fwd_length
        carries = self._zero_carries(int(x.shape[0]))
        for s in range(0, int(x.shape[1]), length):
            w = slice(s, s + length)
            carries = self._train_step(x[:, w], y[:, w] if y.dim() == 3 else y,
                                       None if fm is None else fm[:, w],
                                       None if lm is None else lm[:, w], carries=carries)

    def fit_tbptt_fused(self, x, y) -> "MultiLayerNetwork":
        """Train one (batch, T, ...) sequence batch window by window, T a
        multiple of ``tbptt_fwd_length``, no masks: the JAX package's one
        scan over the windows, here the loop ``fit`` runs, so the two give
        the same parameters bitwise. ``iteration`` advances by the window
        count."""
        if self.params is None:
            self.init()
        if self.conf.backprop_type != "tbptt":
            raise ValueError("fit_tbptt_fused requires backprop_type='tbptt' "
                             "(this network is 'standard'; use fit/fit_fused)")
        x, y = self._as_input(x), self._as_labels(y)
        length, steps = self.conf.tbptt_fwd_length, int(x.shape[1])
        if steps % length != 0:
            raise ValueError(f"sequence length {steps} must be a multiple of "
                             f"tbptt_fwd_length {length} for the fused path")
        self._resume_state = None
        self._fit_tbptt(x, y, None, None)
        self.last_batch_size = int(x.shape[0])
        return self

    def _check_stateful(self):
        for layer in self.layers:
            if not getattr(layer, "supports_stateful", True):
                raise NotImplementedError(
                    f"rnn_time_step is not supported with {type(layer).__name__}: "
                    "the backward direction needs the full sequence (reference "
                    "GravesBidirectionalLSTM.rnnTimeStep throws the same)")

    @torch.inference_mode()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful step-by-step inference (reference rnnTimeStep): each call
        starts from the carries the last one left. ``x`` is one timestep,
        (batch, features) (or (batch,) ids for an id-sequence network), or a
        (batch, time, ...) sequence; the output has the same time axis or
        none. Returns a tensor on the network's device."""
        self._check_stateful()
        if self.params is None:
            self.init()
        index_seq = getattr(self.layers[0], "takes_index_sequence", False)
        x = self._as_input(x)
        squeeze = x.dim() == 1 or (x.dim() == 2 and (not index_seq or x.shape[1] == 1))
        if squeeze:
            x = x.reshape(x.shape[0], 1) if index_seq else x[:, None, :]
        batch = int(x.shape[0])
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(batch)
        else:
            held = [v.shape[0] for c in self._rnn_carries for v in tree_leaves(c)]
            if held and held[0] != batch:
                raise ValueError(
                    f"rnn_time_step batch size {batch} does not match stored state "
                    f"batch {held[0]}; call rnn_clear_previous_state() first")
        acts, _, _, _, self._rnn_carries = self._forward(self.params, self.state, x, False,
                                                         carries=self._rnn_carries)
        return acts[-1][:, 0] if squeeze else acts[-1]

    def _decode_input(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids (batch, t) in the network's input encoding: the ids
        themselves for an id-sequence network, else one-hot rows."""
        if getattr(self.layers[0], "takes_index_sequence", False):
            return ids.to(torch.float32)
        n_in = self.decode_vocab_size()
        return torch.nn.functional.one_hot(ids.long(), n_in).to(torch.float32)

    def _decode_preout(self, preout, what: str) -> torch.Tensor:
        if not isinstance(preout, torch.Tensor):
            raise ValueError(
                f"{what} needs a plain-tensor output layer; "
                f"{type(self.layers[-1]).__name__} produces a structured pre-output")
        return preout

    def decode_step_fn(self):
        """Single-step decode for the serving tier (``serving/decode.py``):
        returns ``f(params, state, carries, tokens)`` with ``tokens`` a
        (batch,) integer id tensor on the network's device, producing
        ``(logits, new_carries)``: the output layer's float32
        PRE-activation (batch, n_out), the sampling input. Ids map to the
        network's input encoding on the device (one-hot, or the ids for an
        id-sequence network), so the caller never builds features on the
        host. Call it under ``torch.inference_mode()``."""
        self._check_stateful()
        if not self.layers[-1].is_output_layer():
            raise ValueError("decode_step_fn needs an output layer last "
                             "(RnnOutputLayer) to expose sampling logits")

        def step(params, state, carries, tokens):
            x = self._decode_input(tokens[:, None])
            _, preout, _, _, new_carries = self._forward(params, state, x, False,
                                                         carries=carries)
            preout = self._decode_preout(preout, "decode_step_fn")
            return preout[:, 0, :].to(torch.float32), new_carries

        return step

    def decode_prefill_fn(self):
        """Masked prefill for the serving tier: returns ``f(params, state,
        ids, length, carries)`` with ``ids`` a right-padded (batch, t)
        integer tensor whose first ``length`` steps are real; the features
        mask holds each recurrent carry through the padded steps, so the
        new carries are the carries after the real prompt. Returns
        ``(logits at position length - 1 (batch, n_out) float32,
        new_carries)``, the JAX engine's ``decode.prefill`` program."""
        self._check_stateful()
        if not self.layers[-1].is_output_layer():
            raise ValueError("decode_prefill_fn needs an output layer last "
                             "(RnnOutputLayer) to expose sampling logits")

        def prefill(params, state, ids, length: int, carries):
            t = ids.shape[1]
            fmask = (torch.arange(t, device=ids.device)[None, :] < int(length)
                     ).to(torch.float32).expand(ids.shape[0], t)
            _, preout, _, _, new_carries = self._forward(
                params, state, self._decode_input(ids), False, mask=fmask,
                carries=carries)
            preout = self._decode_preout(preout, "decode_prefill_fn")
            return preout[:, int(length) - 1, :].to(torch.float32), new_carries

        return prefill

    def decode_vocab_size(self) -> int:
        """Token-id space of the decode loop: the input size (one-hot
        width / embedding vocabulary). The output layer's n_out must match
        it for closed-loop generation; ``serving/decode.py`` checks it."""
        return int(self.conf.layer_input_types()[0].size)

    def rnn_clear_previous_state(self):
        """Forget the stored carries (reference rnnClearPreviousState)."""
        self._rnn_carries = None

    def rnn_get_previous_state(self):
        """The stored carries: one dict a layer, ``{}`` for a layer with none."""
        return self._rnn_carries

    # -------------------------------------------------------------- pretrain
    def _featurize(self, x, upto: int):
        """The inference forward through layers[0:upto] and the
        preprocessor in front of layer ``upto``: the pretraining input."""
        mask = None
        for j in range(upto):
            if j in self._pre:
                x, mask = self._pre[j].apply(x, mask)
            x, _ = self.layers[j].apply(self.params[j], self.state[j], x, train=False,
                                        rng=None, mask=mask)
        if upto in self._pre:
            x, _ = self._pre[upto].apply(x, mask)
        return x

    def pretrain(self, data, num_epochs: int = 1) -> "MultiLayerNetwork":
        """Greedy layerwise pretraining of every pretrainable layer
        (AutoEncoder, RBM, VariationalAutoencoder), in order (reference
        MultiLayerNetwork.pretrain)."""
        if self.params is None:
            self.init()
        for i, layer in enumerate(self.layers):
            if getattr(layer, "is_pretrainable", lambda: False)():
                self.pretrain_layer(i, data, num_epochs)
        return self

    def pretrain_layer(self, i: int, data, num_epochs: int = 1,
                       draws=None) -> "MultiLayerNetwork":
        """Pretrain layer ``i``: featurize each batch through the frozen
        layers below, then one step of the layer's updater on its
        unsupervised ``pretrain_loss`` (in float32, as the JAX package's
        step), constraints after it. The loss draws from the dropout
        generator, unless ``draws`` gives each step's draws in order.
        Listeners see every step; ``iteration`` advances."""
        layer = self.layers[i]
        if not getattr(layer, "is_pretrainable", lambda: False)():
            raise ValueError(f"layer {i} ({type(layer).__name__}) is not pretrainable")
        if self.params is None:
            self.init()
        if self.opt_state is None:
            self._reset_updaters()
        if isinstance(data, DataSet):
            data = [data]
        draws = None if draws is None else iter(draws)
        for _ in range(num_epochs):
            for ds in data:
                x = self._as_input(ds.features if isinstance(ds, DataSet) else ds)
                with torch.no_grad():
                    feats = self._featurize(x, i)
                leaves = tree_map(lambda v: v.detach().requires_grad_(True), self.params[i])
                loss = layer.pretrain_loss(leaves, self.state[i], feats, self._gen,
                                           draws=None if draws is None else next(draws))
                grads = leaf_grads(loss, leaves)
                with torch.no_grad():
                    bucketed_apply([i], self._updaters, self._gnorms, self.params,
                                   {i: grads}, self.opt_state)
                apply_constraints(layer, self.params[i])
                self._score = loss.detach()
                for listener in self.listeners:
                    listener.iteration_done(self, self.iteration, self.epoch)
                self.iteration += 1
        return self

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, num_epochs: int = 1, bucket_policy=None,
            prefetch: bool = False, checkpoint_manager=None) -> "MultiLayerNetwork":
        """Train (reference MultiLayerNetwork.fit): ``data`` is a DataSet, an
        iterable of DataSets, or features with ``labels``. Features, labels
        and masks may be numpy arrays or tensors; tensors already on the
        network's device are used without a copy. ``checkpoint_manager``
        checkpoints per its triggers; a network ``restore_latest`` returned
        resumes at the exact step (``num_epochs`` is then the run's total,
        and ``data`` must replay the interrupted run's batches in order, or
        seek: a ``ShardedReader`` does). ``bucket_policy`` (a
        ``perf.BucketPolicy``, or True for the default) pads every batch to
        its bucket with the padded rows masked out of the loss;
        ``prefetch=True`` stages each batch onto the device while the step
        before it runs (``perf/prefetch.py``). A configuration outside the
        SGD family trains through the full-batch solver instead (module
        docstring)."""
        if self.params is None:
            self.init()
        if labels is not None:
            data = [DataSet(data, labels)]
        elif isinstance(data, DataSet):
            data = [data]
        if not is_sgd_family(self.conf):
            return self._fit_solver(data, num_epochs, checkpoint_manager,
                                    bucket_policy is not None or prefetch)
        return self._fit_epochs(data, num_epochs, checkpoint_manager, self._fit_batch,
                                bucket_policy, prefetch)

    def _fit_solver(self, data, num_epochs: int, checkpoint_manager, ignored: bool):
        """The full-batch solver path of ``fit`` (reference Solver.java's
        dispatch on OptimizationAlgorithm), the JAX package's loop: one
        ``Solver.optimize`` a batch, the listeners and checkpoint hooks
        around it."""
        from deeplearning4j_tpu_torch.checkpoint.manager import (resume_plan,
                                                                 skip_consumed_batches)
        from deeplearning4j_tpu_torch.optimize.solvers import Solver
        if ignored:
            log.warning("fit(bucket_policy=/prefetch=) is ignored on the solver path "
                        "(%s): these options apply to the SGD step loop only",
                        self.conf.optimization_algo)
        epochs_to_run, skip = resume_plan(self, num_epochs)
        if hasattr(data, "bind_epoch"):
            data.bind_epoch(lambda: self.epoch)
        solver = Solver(self.conf.optimization_algo)
        for _ in range(epochs_to_run):
            for listener in self.listeners:
                listener.on_epoch_start(self)
            bi = skip
            for ds in skip_consumed_batches(data, skip):
                bi += 1
                solver.optimize(self, ds)
                self.last_batch_size = ds.num_examples()
                for listener in self.listeners:
                    listener.iteration_done(self, self.iteration, self.epoch)
                self.iteration += 1
                if checkpoint_manager is not None:
                    checkpoint_manager.step_end(self, batch_in_epoch=bi)
            skip = 0
            for listener in self.listeners:
                listener.on_epoch_end(self)
            self.epoch += 1
            if checkpoint_manager is not None:
                checkpoint_manager.epoch_end(self)
        return self

    def fit_fused(self, datasets, bucket_policy=None) -> "MultiLayerNetwork":
        """K steps over a list of equally shaped DataSets, or a pre-stacked
        ``(xs, ys)`` pair of (K, batch, ...) arrays: the JAX package's
        one-dispatch scan, here the same step as ``fit`` in a loop, so it
        gives what ``fit`` on each batch in order gives, bitwise.
        ``bucket_policy`` lets the list form carry a ragged batch: every
        batch pads to the bucket of the largest, its padding masked out of
        the loss (the JAX package's one scan program)."""
        if self.params is None:
            self.init()
        if not is_sgd_family(self.conf):
            raise ValueError("fit_fused supports the jitted SGD-family path "
                             "only; use fit() for solver-based optimization")
        if self.conf.backprop_type == "tbptt":
            raise ValueError("fit_fused does not window tBPTT sequences; "
                             "use fit() for tbptt-configured networks")
        self._resume_state = None  # a fused fit is not a resumable run
        if isinstance(datasets, tuple) and len(datasets) == 2:
            xs, ys = datasets
            if not (hasattr(xs, "shape") and hasattr(ys, "shape")):
                raise TypeError("fit_fused((a, b)) expects pre-stacked (K, batch, ...) "
                                "ARRAYS; pass multiple DataSets as a list")
            if len(xs.shape) < 3:
                raise ValueError("pre-stacked inputs must be (K, batch, ...); for one "
                                 "batch of (features, labels) use fit()")
            datasets = [DataSet(xs[i], ys[i]) for i in range(int(xs.shape[0]))]
        elif bucket_policy is not None:
            from deeplearning4j_tpu_torch.perf.bucketing import BucketPolicy, pad_dataset
            datasets = list(datasets)
            policy = BucketPolicy() if bucket_policy is True else bucket_policy
            sizes = [d.num_examples() for d in datasets]
            target = policy.bucket(max(sizes))
            if any(n != target for n in sizes):
                datasets = [pad_dataset(d, target) for d in datasets]
        for ds in datasets:
            self._fit_batch(ds)
        return self

    def score_dataset(self, ds: DataSet) -> float:
        """Loss on a dataset (reference MultiLayerNetwork.score(DataSet)):
        the inference-mode forward, no dropout, plus l1/l2."""
        if self.params is None:
            self.init()
        x, y, fm, lm = self._batch(ds)
        with torch.no_grad():
            return float(self._loss_fn(self.params, self.state, x, y, None, fm, lm,
                                       train=False)[0])

    def evaluate(self, iterator):
        """Classification evaluation over an iterator of DataSets (reference
        MultiLayerNetwork.evaluate): the inference forward of each batch,
        its features mask threaded through, and ``Evaluation.eval`` over
        the labels mask. On the card the counts accumulate there and are
        read once, when the caller asks for a statistic."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        e = Evaluation()
        for ds in iterator:
            out = self.output(ds.features, features_mask=ds.features_mask)
            e.eval(ds.labels, out, mask=ds.labels_mask)
        return e

    def evaluate_regression(self, iterator):
        """Regression evaluation over an iterator of DataSets."""
        from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
        e = RegressionEvaluation()
        for ds in iterator:
            out = self.output(ds.features, features_mask=ds.features_mask)
            e.eval(ds.labels, out, mask=ds.labels_mask)
        return e
