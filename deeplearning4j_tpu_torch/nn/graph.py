"""ComputationGraph — DAG network with multiple inputs and outputs, trained
with ``fit`` (counterpart of ``deeplearning4j_tpu/nn/graph.py``).

Parameters and state are dicts keyed by vertex name, each a dict of tensors
in the JAX package's layouts, so ``interop.params_from_jax`` and
``interop.state_from_jax`` hand over a JAX graph's weights and running
stats leaf for leaf.

One training step (``_fit_batch``) is the step of ``nn/training.py``,
which ``MultiLayerNetwork`` shares: float32 masters cast to the compute
dtype inside autograd (the inputs are cast too; output-layer
pre-activations go to float32 for the loss), the loss the sum of every
output layer's score plus l1/l2, each layer's gradients through its
gradient normalization and its updater, added to the masters in place, and
batch-norm running stats updated **in place** under ``torch.no_grad()``,
where the JAX package returns new state.

Features masks (one (batch, time) mask per network input, or None) are
threaded through the DAG as the JAX package's ``_forward`` threads them:
each vertex takes the mask of its first masked input; a layer vertex's
preprocessor and the layer itself get it, and its output keeps it only
while the output has a time axis (``rnn`` / ``cnn1d``);
``LastTimeStepVertex`` reads the mask of its input (or of ``mask_input``)
and returns each row's last unmasked step; ``DuplicateToTimeSeriesVertex``
takes its reference input's mask; every other vertex passes its input's
mask on. An output layer without a labels mask is scored over the mask
that reaches it.

Truncated BPTT (``backprop_type="tbptt"``): ``fit`` cuts a batch whose
sequence inputs are longer than ``tbptt_fwd_length`` into windows of that
length (the last one ragged), the masks and 3-D labels with them, and
takes one updater step a window; each recurrent vertex's carry goes from
one window into the next detached, as in ``MultiLayerNetwork``.
``rnn_time_step`` carries the same state across calls.

``fit`` runs the shared epoch loop (``TrainStep._fit_epochs``): listeners
and ``checkpoint_manager``, with exact-step resume of a restored graph,
``bucket_policy`` (``pad_multi_dataset``), ``prefetch`` and the
``train.data_wait`` span. ``set_augmentation`` augments every 4-D input of
the train step, each with its own draws. ``evaluate`` is the JAX
package's.

``init`` validates the configuration first (``conf.validate()``,
``analysis/validation.py``) unless ``validate=False`` or
``DL4J_TPU_VALIDATE=0``.

With ``grad_compression`` set (``parallel.enable_grad_compression``),
every step of ``fit``, ``fit_fused`` and the tBPTT windows compresses its
gradients with error feedback (``nn/training.py``); inside a
``parallel.ClusterTrainer`` step the gradients are first averaged over the
data group.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph import (ComputationGraphConfiguration,
                                                    DuplicateToTimeSeriesVertex,
                                                    LastTimeStepVertex)
from deeplearning4j_tpu_torch.nn.conf.layers import (Layer, apply_layer, dropout_input,
                                                     noisy_params, regularization_penalty)
from deeplearning4j_tpu_torch.nn.conf.normalization import LOW_PRECISION
from deeplearning4j_tpu_torch.nn.training import TrainStep, to_float32
from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map


class ComputationGraph(TrainStep):
    """DAG network. ``device`` follows the port's device rule: ``cuda``
    unless the caller passes ``device="cpu"``."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.device = resolve_device(device)
        self.conf = conf
        self.order: List[str] = conf.topological_order()
        self.vertices = conf.wired_vertices()
        self.vertex_input_types = conf.vertex_input_types()
        self._vpre = conf.resolved_vertex_preprocessors()
        self._layer_names = [n for n in self.order
                             if isinstance(self.vertices[n][0], Layer)]
        self._init_training({n: self.vertices[n][0] for n in self._layer_names})
        for out in conf.network_outputs:
            obj = self.vertices[out][0]
            if not (isinstance(obj, Layer) and obj.is_output_layer()):
                raise ValueError(f"Network output '{out}' must be an output/loss layer")
        self.params: Optional[Dict[str, dict]] = None
        self.state: Optional[Dict[str, dict]] = None
        # whether each layer vertex's output keeps the time axis its features
        # mask applies to
        self._mask_survives = {
            n: self.vertices[n][0].output_type(self.vertex_input_types[n][0]).kind
            in ("rnn", "cnn1d") for n in self._layer_names}
        self._rnn_carries: Optional[dict] = None  # rnn_time_step's stored state

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None,
             validate: Optional[bool] = None) -> "ComputationGraph":
        """Draw every layer's parameters, in topological order, from one
        ``torch.Generator`` on the graph's device seeded with ``conf.seed``
        (or ``seed``); dropout draws from a second one (seed + 1). Runs
        ``conf.validate()`` first; opt out with ``validate=False`` or
        ``DL4J_TPU_VALIDATE=0``."""
        self._validate(validate)
        seed = self.conf.seed if seed is None else int(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params, state = {}, {}
        for name in self.order:
            obj, _ = self.vertices[name]
            if isinstance(obj, Layer):
                params[name], state[name] = obj.init(
                    gen, self.vertex_input_types[name][0], self.device)
            else:
                params[name], state[name] = {}, {}
        self._seed_dropout(seed)
        return self.set_params(params, state)

    def set_params(self, params: Dict[str, dict], state: Dict[str, dict]):
        """Take these parameters and state (e.g. from ``interop``); updater
        state starts anew."""
        self.params, self.state = params, state
        self._reset_updaters()
        return self

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, inputs, train: bool, rng=None, masks=None,
                 carries=None, only=None):
        """Run the DAG. Returns (activations, output pre-activations, new
        state, each vertex's features mask, new carries), all dicts keyed by
        vertex name. ``masks`` holds one (batch, time) mask or None per
        network input. With ``carries`` (one per layer vertex, ``{}`` where
        a layer has none) each recurrent vertex that supports stateful use
        starts from its carry and returns its new one (tBPTT,
        ``rnn_time_step``); without, the new carries are empty. ``only``
        (a set of vertex names, closed under inputs) runs just those
        vertices (``TransferLearningHelper.featurize``)."""
        cdt = self._dtype
        params = self._cast(params)
        acts: Dict[str, torch.Tensor] = {}
        mask_of: Dict[str, Optional[torch.Tensor]] = {}
        for i, name in enumerate(self.conf.network_inputs):
            x = inputs[i]
            acts[name] = (x.to(cdt) if cdt != torch.float32 and x.is_floating_point()
                          else x)
            mask_of[name] = None if masks is None else masks[i]
        new_state, preouts, new_carries = {}, {}, {}
        for name in self.order:
            if only is not None and name not in only:
                continue
            obj, in_names = self.vertices[name]
            xs = [acts[i] for i in in_names]
            in_mask = next((mask_of[i] for i in in_names if mask_of[i] is not None), None)
            new_state[name] = state[name]
            if isinstance(obj, Layer):
                if name in self._vpre:
                    xs[0], in_mask = self._vpre[name].apply(xs[0], in_mask)
                p_v = noisy_params(obj, params[name], rng, train)
                if obj.is_output_layer():
                    x_in = dropout_input(xs[0], obj.dropout, train, rng)
                    z = to_float32(obj.pre_output(p_v, x_in))
                    preouts[name] = z
                    out = obj.output_activations(z)
                elif (carries is not None and hasattr(obj, "apply_seq")
                      and getattr(obj, "supports_stateful", True)):
                    out, new_carries[name] = obj.apply_seq(
                        p_v, carries[name],
                        dropout_input(xs[0], obj.dropout, train, rng),
                        train=train, rng=None, mask=in_mask)
                else:
                    # fused conv→BN→act blocks with residual=True take the
                    # residual-add operand as a second vertex input
                    extra = ({"res": xs[1]}
                             if getattr(obj, "residual", False) and len(xs) > 1
                             else None)
                    out, new_state[name] = apply_layer(
                        obj, p_v, state[name], xs[0], train=train,
                        rng=rng, mask=in_mask, extra=extra)
                mask_of[name] = in_mask if self._mask_survives[name] else None
            elif isinstance(obj, LastTimeStepVertex):
                m = in_mask if obj.mask_input is None else mask_of.get(obj.mask_input)
                out = obj.apply(*xs, mask=m)
                mask_of[name] = None
            elif isinstance(obj, DuplicateToTimeSeriesVertex):
                out = obj.apply(*xs, time_steps=acts[obj.reference_input].shape[1])
                mask_of[name] = mask_of.get(obj.reference_input)
            else:
                out = obj.apply(*xs)
                mask_of[name] = in_mask
            acts[name] = out
        if carries is not None:
            for n in carries:
                new_carries.setdefault(n, carries[n])
        return acts, preouts, new_state, mask_of, new_carries

    def _regularization(self, params):
        """l1/l2 over every layer's regularizable paths and biases, nested
        ones included (the JAX package's ``_regularization``)."""
        total = 0.0
        for name in self._layer_names:
            total = total + regularization_penalty(self.vertices[name][0], params[name])
        return total

    def _loss_fn(self, params, state, inputs, labels, rng=None, fmasks=None,
                 lmasks=None, carries=None):
        """Train-mode loss over all output layers plus regularization, and
        the new state (the JAX package's ``_loss_fn``); an output without a
        labels mask is scored over the features mask that reaches it. With
        ``carries`` (a tBPTT window), also the new carries, detached."""
        inputs = [self._augment(x, rng) if x.dim() == 4 else x for x in inputs]
        _, preouts, new_state, mask_of, new_carries = self._forward(
            params, state, inputs, True, rng, fmasks, carries)
        loss = 0.0
        for j, out_name in enumerate(self.conf.network_outputs):
            y = labels[j]
            if y.dtype in LOW_PRECISION:
                y = y.float()
            lm = None if lmasks is None else lmasks[j]
            if lm is None:
                lm = mask_of.get(out_name)
            loss = loss + self.vertices[out_name][0].compute_score(
                y, preouts[out_name], lm)
        loss = loss + self._regularization(params)
        if carries is None:
            return loss, new_state
        return loss, new_state, tree_map(torch.Tensor.detach, new_carries)

    # ------------------------------------------------------------------- fit
    def fit(self, data, num_epochs: int = 1, bucket_policy=None,
            prefetch: bool = False, checkpoint_manager=None):
        """Train on MultiDataSets, DataSets (single input and output) or an
        iterable of them, ``num_epochs`` times over. ``checkpoint_manager``
        checkpoints per its triggers; a graph ``restore_latest`` returned
        resumes at the exact step (``num_epochs`` is then the run's total).
        ``bucket_policy`` and ``prefetch`` as in ``MultiLayerNetwork.fit``."""
        if self.params is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        return self._fit_epochs(data, num_epochs, checkpoint_manager, self._fit_batch,
                                bucket_policy, prefetch)

    def _as_tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if x.dtype == np.float64:  # the JAX package computes it in float32
                x = x.astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _masks(self, masks):
        return None if masks is None else [None if m is None else self._as_tensor(m)
                                           for m in masks]

    def _batch(self, mds: MultiDataSet):
        """(inputs, labels, features masks, labels masks) on the device."""
        return ([self._as_tensor(f) for f in mds.features],
                [self._as_tensor(y) for y in mds.labels],
                self._masks(mds.features_masks), self._masks(mds.labels_masks))

    def _fit_batch(self, ds):
        mds = MultiDataSet.from_dataset(ds) if isinstance(ds, DataSet) else ds
        inputs, labels, fmasks, lmasks = self._batch(mds)
        lengths = [int(x.shape[1]) for i, x in enumerate(inputs)
                   if self._time_sliceable(i, x)]
        if (self.conf.backprop_type == "tbptt" and lengths
                and max(lengths) > self.conf.tbptt_fwd_length):
            self._fit_tbptt(inputs, labels, fmasks, lmasks, max(lengths))
        else:
            self._train_step(inputs, labels, fmasks, lmasks)
        self.last_batch_size = int(inputs[0].shape[0])

    # ------------------------------------------------- truncated BPTT / state
    def _time_sliceable(self, i: int, x: torch.Tensor) -> bool:
        """Whether network input ``i`` has a time axis to window over: 3-D
        sequences, or 2-D integer id sequences under an RNN input type."""
        its = self.conf.input_types
        it = its[i] if i < len(its) else None
        return x.dim() == 3 or (x.dim() == 2 and it is not None and it.kind == "rnn"
                                and not x.is_floating_point())

    def _zero_carries(self, batch: int) -> dict:
        return {n: (self.vertices[n][0].init_carry(batch, self._dtype, self.device)
                    if hasattr(self.vertices[n][0], "init_carry") else {})
                for n in self._layer_names}

    def _fit_tbptt(self, inputs, labels, fmasks, lmasks, steps: int):
        """One updater step a window of ``tbptt_fwd_length`` timesteps (the
        last window ragged), the carries going on detached."""
        length = self.conf.tbptt_fwd_length
        carries = self._zero_carries(int(inputs[0].shape[0]))

        def cut(ms, w):
            return None if ms is None else [None if m is None else m[:, w] for m in ms]

        for s in range(0, steps, length):
            w = slice(s, s + length)
            xs = [x[:, w] if self._time_sliceable(i, x) else x
                  for i, x in enumerate(inputs)]
            ys = [y[:, w] if y.dim() == 3 else y for y in labels]
            carries = self._train_step(xs, ys, cut(fmasks, w), cut(lmasks, w),
                                       carries=carries)

    @torch.inference_mode()
    def rnn_time_step(self, *inputs) -> List[np.ndarray]:
        """Stateful step-by-step inference (reference rnnTimeStep): each call
        starts from the carries the last one left. A sequence input is one
        timestep, (batch, features) (or (batch,) ids), or a (batch, time,
        ...) sequence; with a single timestep the outputs lose their time
        axis. Returns every network output as a numpy array."""
        for n in self._layer_names:
            obj = self.vertices[n][0]
            if not getattr(obj, "supports_stateful", True):
                raise NotImplementedError(
                    f"rnn_time_step is not supported with {type(obj).__name__} in "
                    f"vertex '{n}': the backward direction needs the full sequence")
        if self.params is None:
            self.init()
        its = self.conf.input_types
        xs, squeeze = [], False
        for i, x in enumerate(inputs):
            x = self._as_tensor(x)
            it = its[i] if i < len(its) else None
            if it is not None and it.kind == "rnn":
                if not x.is_floating_point():
                    if x.dim() == 1:  # (batch,) ids, one timestep
                        x, squeeze = x[:, None], True
                    elif x.dim() == 2 and x.shape[1] == 1:
                        squeeze = True
                elif x.dim() == 2:  # (batch, features), one timestep
                    x, squeeze = x[:, None, :], True
            xs.append(x)
        batch = int(xs[0].shape[0])
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(batch)
        else:
            held = [v.shape[0] for c in self._rnn_carries.values() for v in tree_leaves(c)]
            if held and held[0] != batch:
                raise ValueError(
                    f"rnn_time_step batch size {batch} does not match stored state "
                    f"batch {held[0]}; call rnn_clear_previous_state() first")
        acts, _, _, _, self._rnn_carries = self._forward(
            self.params, self.state, xs, False, carries=self._rnn_carries)
        outs = [acts[n].cpu().numpy() for n in self.conf.network_outputs]
        return [o[:, -1] if squeeze and o.ndim == 3 else o for o in outs]

    def rnn_clear_previous_state(self):
        """Forget the stored carries (reference rnnClearPreviousState)."""
        self._rnn_carries = None

    def rnn_get_previous_state(self):
        """The stored carries: one dict a layer vertex, ``{}`` for a layer
        with none."""
        return self._rnn_carries

    # ---------------------------------------------------------------- output
    def output(self, *inputs, features_masks=None) -> List[np.ndarray]:
        """Inference outputs of every network output, as numpy arrays;
        ``features_masks`` holds one mask or None per network input."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            outs = self._watched("output", self._output)(
                [self._as_tensor(x) for x in inputs], self._masks(features_masks))
            return [o.cpu().numpy() for o in outs]

    def _output(self, inputs, masks):
        acts = self._forward(self.params, self.state, inputs, False, masks=masks)[0]
        return [acts[n] for n in self.conf.network_outputs]

    def output_single(self, *inputs, features_masks=None) -> np.ndarray:
        return self.output(*inputs, features_masks=features_masks)[0]

    def predict(self, *inputs, features_masks=None) -> np.ndarray:
        return np.argmax(self.output_single(*inputs, features_masks=features_masks),
                         axis=-1)

    def score_dataset(self, ds) -> float:
        """The train-mode loss on ``ds`` (batch statistics, no dropout, no
        update), as the JAX package scores."""
        mds = MultiDataSet.from_dataset(ds) if isinstance(ds, DataSet) else ds
        inputs, labels, fmasks, lmasks = self._batch(mds)
        with torch.no_grad():
            return float(self._watched("score", self._score_loss)(inputs, labels, fmasks,
                                                                  lmasks))

    def _score_loss(self, inputs, labels, fmasks, lmasks):
        return self._loss_fn(self.params, self.state, inputs, labels, None, fmasks,
                             lmasks)[0]

    def evaluate(self, iterator):
        """Classification evaluation over an iterator of DataSets (reference
        ComputationGraph.evaluate) of the first network output, each
        batch's features mask threaded through the inference forward. On
        the card the counts accumulate there and are read once, when the
        caller asks for a statistic."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        if self.params is None:
            self.init()
        e = Evaluation()
        out_name = self.conf.network_outputs[0]
        for ds in iterator:
            fm = None if ds.features_mask is None else [ds.features_mask]
            with torch.no_grad():
                # the output stays on the device: Evaluation counts there
                out = self._forward(self.params, self.state, [self._as_tensor(ds.features)],
                                    False, masks=self._masks(fm))[0][out_name]
            e.eval(ds.labels, out, mask=ds.labels_mask)
        return e
