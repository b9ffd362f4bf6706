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

Not ported (they raise ``NotImplementedError``): ``bucket_policy``,
``prefetch``, ``checkpoint_manager``, truncated BPTT, gradient compression,
augmentation and feature masks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph import (ComputationGraphConfiguration,
                                                    DuplicateToTimeSeriesVertex)
from deeplearning4j_tpu_torch.nn.conf.layers import (Layer, apply_layer, dropout_input,
                                                     regularization_penalty)
from deeplearning4j_tpu_torch.nn.conf.normalization import LOW_PRECISION
from deeplearning4j_tpu_torch.nn.training import TrainStep


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

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Draw every layer's parameters, in topological order, from one
        ``torch.Generator`` on the graph's device seeded with ``conf.seed``
        (or ``seed``); dropout draws from a second one (seed + 1)."""
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

    def set_augmentation(self, augmentation):
        raise NotImplementedError("on-device augmentation is not in the PyTorch port yet")

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, inputs, train: bool, rng=None):
        """Run the DAG. Returns (activations, output pre-activations, new
        state), all dicts keyed by vertex name."""
        cdt = self._dtype
        params = self._cast(params)
        acts: Dict[str, torch.Tensor] = {}
        for name, x in zip(self.conf.network_inputs, inputs):
            acts[name] = (x.to(cdt) if cdt != torch.float32 and x.is_floating_point()
                          else x)
        new_state, preouts = {}, {}
        for name in self.order:
            obj, in_names = self.vertices[name]
            xs = [acts[i] for i in in_names]
            new_state[name] = state[name]
            if isinstance(obj, Layer):
                if name in self._vpre:
                    xs[0], _ = self._vpre[name].apply(xs[0], None)
                if obj.is_output_layer():
                    x_in = dropout_input(xs[0], obj.dropout, train, rng)
                    z = obj.pre_output(params[name], x_in)
                    if z.dtype in LOW_PRECISION:  # loss math in float32
                        z = z.float()
                    preouts[name] = z
                    out = obj.output_activations(z)
                else:
                    # fused conv→BN→act blocks with residual=True take the
                    # residual-add operand as a second vertex input
                    extra = ({"res": xs[1]}
                             if getattr(obj, "residual", False) and len(xs) > 1
                             else None)
                    out, new_state[name] = apply_layer(
                        obj, params[name], state[name], xs[0], train=train,
                        rng=rng, extra=extra)
            elif isinstance(obj, DuplicateToTimeSeriesVertex):
                out = obj.apply(*xs, time_steps=acts[obj.reference_input].shape[1])
            else:
                out = obj.apply(*xs)
            acts[name] = out
        return acts, preouts, new_state

    def _regularization(self, params):
        """l1/l2 over every layer's regularizable paths and biases, nested
        ones included (the JAX package's ``_regularization``)."""
        total = 0.0
        for name in self._layer_names:
            total = total + regularization_penalty(self.vertices[name][0], params[name])
        return total

    def _loss_fn(self, params, state, inputs, labels, rng=None, lmasks=None):
        """Train-mode loss over all output layers plus regularization, and
        the new state (the JAX package's ``_loss_fn``)."""
        _, preouts, new_state = self._forward(params, state, inputs, True, rng)
        loss = 0.0
        for j, out_name in enumerate(self.conf.network_outputs):
            y = labels[j]
            if y.dtype in LOW_PRECISION:
                y = y.float()
            lm = None if lmasks is None else lmasks[j]
            loss = loss + self.vertices[out_name][0].compute_score(
                y, preouts[out_name], lm)
        return loss + self._regularization(params), new_state

    # ------------------------------------------------------------------- fit
    def fit(self, data, num_epochs: int = 1, bucket_policy=None,
            prefetch: bool = False, checkpoint_manager=None):
        """Train on MultiDataSets, DataSets (single input and output) or a
        list of them, ``num_epochs`` times over."""
        self._refuse(bucket_policy=bucket_policy, prefetch=prefetch,
                     checkpoint_manager=checkpoint_manager,
                     tbptt=self.conf.backprop_type == "tbptt")
        if self.params is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        for _ in range(num_epochs):
            for ds in data:
                self._fit_batch(MultiDataSet.from_dataset(ds)
                                if isinstance(ds, DataSet) else ds)
            self.epoch += 1
        return self

    def _as_tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if x.dtype == np.float64:  # the JAX package computes it in float32
                x = x.astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _batch(self, mds: MultiDataSet):
        if mds.features_masks is not None and any(m is not None
                                                  for m in mds.features_masks):
            raise NotImplementedError("feature masks are not in the PyTorch port yet")
        inputs = [self._as_tensor(f) for f in mds.features]
        labels = [self._as_tensor(y) for y in mds.labels]
        lmasks = (None if mds.labels_masks is None else
                  [None if m is None else self._as_tensor(m) for m in mds.labels_masks])
        return inputs, labels, lmasks

    def _fit_batch(self, mds: MultiDataSet):
        inputs, labels, lmasks = self._batch(mds)
        self._train_step(inputs, labels, lmasks)
        self.last_batch_size = int(inputs[0].shape[0])

    # ---------------------------------------------------------------- output
    def output(self, *inputs, features_masks=None) -> List[np.ndarray]:
        """Inference outputs of every network output, as numpy arrays."""
        if features_masks is not None:
            raise NotImplementedError("feature masks are not in the PyTorch port yet")
        if self.params is None:
            self.init()
        with torch.no_grad():
            acts, _, _ = self._forward(self.params, self.state,
                                       [self._as_tensor(x) for x in inputs], False)
            return [acts[n].cpu().numpy() for n in self.conf.network_outputs]

    def output_single(self, *inputs, features_masks=None) -> np.ndarray:
        return self.output(*inputs, features_masks=features_masks)[0]

    def predict(self, *inputs, features_masks=None) -> np.ndarray:
        return np.argmax(self.output_single(*inputs, features_masks=features_masks),
                         axis=-1)

    def score_dataset(self, ds) -> float:
        """The train-mode loss on ``ds`` (batch statistics, no dropout, no
        update), as the JAX package scores."""
        mds = MultiDataSet.from_dataset(ds) if isinstance(ds, DataSet) else ds
        inputs, labels, lmasks = self._batch(mds)
        with torch.no_grad():
            return float(self._loss_fn(self.params, self.state, inputs, labels,
                                       None, lmasks)[0])
