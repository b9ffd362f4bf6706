"""Fusion, BN folding and rematerialization (counterpart of
``deeplearning4j_tpu/perf/fusion.py``: ``fuse``, ``fuse_network``,
``fold_bn``, ``REMAT_POLICIES`` / ``remat_policy``).

- ``fuse(conf)`` pattern-matches a chain head (ConvolutionLayer,
  SeparableConvolution2D or Convolution1DLayer, identity activation) →
  BatchNormalization → ActivationLayer (→ ElementWiseVertex add →
  ActivationLayer, 2-D heads in a graph only) in ``MultiLayerConfiguration``
  stacks and ``ComputationGraphConfiguration`` DAGs, and replaces each with
  a ``FusedConvBNActivation``, ``FusedSeparableConvBNActivation`` or
  ``FusedConv1DBNActivation`` block, whose BN tail runs the ``bn_act``
  kernels. The rewrite is the JAX package's step for step, so both packages
  give the same fused configuration (vertex names, order, fields) and the
  same parameter mapping: the fused vertex keeps the last matched vertex's
  name and the head's layer name, and takes the head's params plus the
  BN's gamma/beta and running stats.
- ``fold_bn(net)`` folds every inference-mode BN behind an
  identity-activation head into the head's weights and bias
  (W' = W * scale, b' = b * scale + shift per output channel; into the
  pointwise kernel for a separable head), and collapses every fused block
  back into its head conv; a residual fused block in a graph expands into
  the BN-free conv → add → activation triple, the activation keeping the
  vertex's name. For serving: train-mode semantics are gone.
- ``remat=`` on a layer recomputes its forward in the backward
  (:func:`remat_apply`, ``torch.utils.checkpoint`` without reentrancy).
  The port's layers draw dropout from an explicit ``torch.Generator``,
  which ``checkpoint``'s ``preserve_rng_state`` does not restore, so
  :func:`remat_apply` records that generator's state before the forward,
  replays the recompute from it and gives the generator back its own state
  after: the recompute draws the same masks, and the math is the same
  bitwise.

``training_activation_bytes(conf, minibatch, augmentation)`` measures the
saved set of one train-mode loss forward, the JAX package's definition:
every tensor the backward keeps, parameters included, each storage counted
once. The forward runs on the ``meta`` device, which allocates nothing (as
the JAX package's jaxpr route), under ``torch.autograd.graph.
saved_tensors_hooks``, whose pack hook sees each tensor autograd saves. The
bn kernels' ``autograd.Function`` saves on meta what it saves on the card
(its plain body runs there, ``perf/kernels/__init__.py``); a rematted
layer's ``torch.utils.checkpoint`` saves its inputs through the same hook
and keeps its own hooks inside, so its inner residuals are not counted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn.conf.convolutional import (Convolution1DLayer,
                                                            ConvolutionLayer,
                                                            FusedConv1DBNActivation,
                                                            FusedConvBNActivation,
                                                            FusedSeparableConvBNActivation,
                                                            SeparableConvolution2D)
from deeplearning4j_tpu_torch.nn.conf.graph import (ComputationGraphConfiguration,
                                                    ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.normalization import BatchNormalization
from deeplearning4j_tpu_torch.nn.tree import tree_map

__all__ = ["REMAT_POLICIES", "remat_policy", "remat_apply", "fuse", "fuse_network",
           "fold_bn", "training_activation_bytes"]


# ----------------------------------------------------------------- remat
#: the JAX package's policy names -> what the port saves for the backward.
#: ``everything_saveable`` keeps autograd's own saves (no recompute). Every
#: other name saves only the layer's inputs and recomputes its whole
#: forward: torch has no counterpart of jax.checkpoint's policies that keep
#: the matmul and conv outputs (``dots_saveable``,
#: ``dots_with_no_batch_dims_saveable``), so those recompute them too.
REMAT_POLICIES = {
    "full": "recompute",
    "nothing_saveable": "recompute",
    "dots_saveable": "recompute",
    "dots_with_no_batch_dims_saveable": "recompute",
    "everything_saveable": "save",
}


def remat_policy(name: str) -> str:
    """What a ``remat=`` value does ("recompute" or "save"); ValueError on
    an unknown name."""
    try:
        return REMAT_POLICIES[str(name)]
    except KeyError:
        raise ValueError(f"Unknown remat policy '{name}' "
                         f"(known: {sorted(REMAT_POLICIES)})") from None


def remat_apply(layer, params, state, x, *, rng: Optional[torch.Generator], mask=None,
                extra=None):
    """A layer's training forward under its ``remat=`` policy: ``(out,
    new_state)`` as ``layer.apply`` gives them."""
    extra = extra or {}

    def run(p, s, xx, mm, ee):
        return layer.apply(p, s, xx, train=True, rng=rng, mask=mm, **ee)

    if remat_policy(layer.remat) == "save":
        return run(params, state, x, mask, extra)
    start = None if rng is None else rng.get_state()
    calls = []

    def replayed(p, s, xx, mm, ee):
        if not calls or rng is None:  # the forward itself
            calls.append(1)
            return run(p, s, xx, mm, ee)
        own = rng.get_state()  # the recompute: the forward's draws again
        rng.set_state(start)
        try:
            return run(p, s, xx, mm, ee)
        finally:
            rng.set_state(own)

    return checkpoint(replayed, params, state, x, mask, extra, use_reentrant=False)


def _updaters_compatible(conv, bn) -> bool:
    """The fused params share one update chain: the BN may carry only the
    conv's per-layer updater and gradient normalization, or none."""
    bu = getattr(bn, "updater", None)
    if bu is not None and bu != getattr(conv, "updater", None):
        return False
    bgn = getattr(bn, "gradient_normalization", None)
    if bgn is not None:
        if bgn != getattr(conv, "gradient_normalization", None):
            return False
        if (getattr(bn, "gradient_normalization_threshold", 1.0)
                != getattr(conv, "gradient_normalization_threshold", 1.0)):
            return False
    return True


# chain heads the rewriter matches ahead of a BatchNormalization (the fused
# classes subclass BaseLayer, so a fused block never matches again)
_FUSABLE_HEADS = (ConvolutionLayer, SeparableConvolution2D, Convolution1DLayer)


def _head_matchable(layer) -> bool:
    return isinstance(layer, _FUSABLE_HEADS) and layer.activation == "identity"


def _bn_matchable(conv, bn) -> bool:
    return (isinstance(bn, BatchNormalization)
            and not bn.lock_gamma_beta
            and not bn.dropout
            and bn.remat is None
            and _updaters_compatible(conv, bn))


def _act_matchable(act) -> bool:
    return (isinstance(act, ActivationLayer)
            and act.activation_param is None
            and not act.dropout
            and act.remat is None)


def _common_fused_kwargs(conv, bn, activation: str, name: Optional[str]) -> dict:
    return dict(
        name=name if name is not None else conv.name,
        dropout=conv.dropout, remat=conv.remat, activation=activation,
        weight_init=conv.weight_init, dist=conv.dist, bias_init=conv.bias_init,
        l1=conv.l1, l2=conv.l2, l1_bias=conv.l1_bias, l2_bias=conv.l2_bias,
        updater=conv.updater, gradient_normalization=conv.gradient_normalization,
        gradient_normalization_threshold=conv.gradient_normalization_threshold,
        constraints=conv.constraints, weight_noise=conv.weight_noise,
        n_in=conv.n_in, n_out=conv.n_out, kernel_size=conv.kernel_size,
        stride=conv.stride, padding=conv.padding,
        convolution_mode=conv.convolution_mode, has_bias=conv.has_bias,
        decay=bn.decay, eps=bn.eps, gamma=bn.gamma, beta=bn.beta)


def _make_fused(conv, bn: BatchNormalization, activation: str, residual: bool = False,
                name: Optional[str] = None):
    """The fused block for a matched chain head; residual adds only on the
    2-D head."""
    kw = _common_fused_kwargs(conv, bn, activation, name)
    if isinstance(conv, ConvolutionLayer):
        return FusedConvBNActivation(dilation=conv.dilation, residual=residual, **kw)
    assert not residual, "residual fusion is 2-D-conv only"
    if isinstance(conv, SeparableConvolution2D):
        return FusedSeparableConvBNActivation(depth_multiplier=conv.depth_multiplier, **kw)
    return FusedConv1DBNActivation(dilation=conv.dilation, **kw)


def _fuse_multilayer(conf: MultiLayerConfiguration):
    """Returns (fused conf, mapping). mapping entries: ("copy", i) or
    ("fuse", conv_i, bn_i, act_i_or_None) in new-layer order."""
    pres = dict(conf.input_preprocessors or {})
    layers = list(conf.layers)
    new_layers: List = []
    new_pres: Dict[int, object] = {}
    mapping: List[tuple] = []
    i = 0
    while i < len(layers):
        l = layers[i]
        fused = None
        span = 1
        if (_head_matchable(l) and i + 1 < len(layers)
                and (i + 1) not in pres and _bn_matchable(l, layers[i + 1])):
            bn = layers[i + 1]
            act, span = "identity", 2
            act_i = None
            if (i + 2 < len(layers) and (i + 2) not in pres
                    and _act_matchable(layers[i + 2])):
                act, span, act_i = layers[i + 2].activation, 3, i + 2
            fused = _make_fused(l, bn, act)
        if i in pres:
            new_pres[len(new_layers)] = pres[i]
        if fused is not None:
            mapping.append(("fuse", i, i + 1, act_i))
            new_layers.append(fused)
            i += span
        else:
            mapping.append(("copy", i))
            new_layers.append(l)
            i += 1
    new_conf = dataclasses.replace(conf, layers=tuple(new_layers),
                                   input_preprocessors=new_pres or None)
    return new_conf, mapping


def _fuse_graph(conf: ComputationGraphConfiguration):
    """Returns (fused conf, mapping). mapping: new vertex name ->
    {"conv": name, "bn": name}. Matched chains have fan-out 1 at every
    interior edge and touch no network output; the residual add's other
    operand becomes the fused vertex's second input."""
    vertices = dict(conf.vertices)
    outputs = set(conf.network_outputs)
    mapping: Dict[str, dict] = {}
    changed = True
    while changed:
        changed = False
        consumers: Dict[str, List[str]] = {}
        for n, (_, ins) in vertices.items():
            for inp in ins:
                consumers.setdefault(inp, []).append(n)
        for cname in list(vertices):
            cobj, cins = vertices[cname]
            if not _head_matchable(cobj):
                continue
            if cname in outputs or len(consumers.get(cname, ())) != 1:
                continue
            bname = consumers[cname][0]
            bobj, bins = vertices[bname]
            if bins != (cname,) or not _bn_matchable(cobj, bobj):
                continue
            if bname in outputs or len(consumers.get(bname, ())) != 1:
                continue
            nxt = consumers[bname][0]
            nobj, nins = vertices[nxt]
            add_name = act_name = res_input = None
            act = "identity"
            if _act_matchable(nobj) and nins == (bname,):
                act_name, act = nxt, nobj.activation
            elif (isinstance(cobj, ConvolutionLayer)  # residual: 2-D heads only
                  and isinstance(nobj, ElementWiseVertex)
                  and nobj.op.lower() == "add" and len(nins) == 2
                  and nxt not in outputs
                  and len(consumers.get(nxt, ())) == 1):
                anxt = consumers[nxt][0]
                aobj, ains = vertices[anxt]
                if _act_matchable(aobj) and ains == (nxt,):
                    add_name, act_name, act = nxt, anxt, aobj.activation
                    res_input = nins[0] if nins[1] == bname else nins[1]
            new_name = act_name if act_name is not None else bname
            fused = _make_fused(cobj, bobj, act, residual=res_input is not None,
                                name=cobj.name or cname)
            inputs = (cins[0],) + ((res_input,) if res_input else ())
            vertices[new_name] = (fused, inputs)
            for dead in (cname, bname, add_name):
                if dead is not None and dead != new_name:
                    vertices.pop(dead)
            mapping[new_name] = {"conv": cname, "bn": bname}
            changed = True
            break  # the consumer map is stale: rebuild and rescan
    return dataclasses.replace(conf, vertices=vertices), mapping


def fuse(conf):
    """Fusion rewrite of a ``MultiLayerConfiguration`` or
    ``ComputationGraphConfiguration``; unmatched layers are untouched."""
    if isinstance(conf, MultiLayerConfiguration):
        return _fuse_multilayer(conf)[0]
    if isinstance(conf, ComputationGraphConfiguration):
        return _fuse_graph(conf)[0]
    raise TypeError(f"fuse() expects a network configuration, got "
                    f"{type(conf).__name__}")


def _copy(d: dict) -> dict:
    return tree_map(lambda v: v.detach().clone(), d)


def _fused_params(conv_p: dict, bn_p: dict) -> dict:
    p = _copy(conv_p)
    p["gamma"] = bn_p["gamma"].detach().clone()
    p["beta"] = bn_p["beta"].detach().clone()
    return p


def fuse_network(net):
    """Fuse a (possibly trained) network: rewrites the conf and maps the
    conv/BN parameters and running stats onto the fused layout, so the
    fused network computes the same function. Updater state starts anew."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(net, MultiLayerNetwork):
        new_conf, mapping = _fuse_multilayer(net.conf)
        out = MultiLayerNetwork(new_conf, net.device)
        if net.params is not None:
            params, state = [], []
            for entry in mapping:
                if entry[0] == "copy":
                    params.append(_copy(net.params[entry[1]]))
                    state.append(_copy(net.state[entry[1]]))
                else:
                    _, ci, bi, _ = entry
                    params.append(_fused_params(net.params[ci], net.params[bi]))
                    state.append(_copy(net.state[bi]))
            out.params, out.state = params, state
        return out
    if isinstance(net, ComputationGraph):
        new_conf, mapping = _fuse_graph(net.conf)
        out = ComputationGraph(new_conf, net.device)
        if net.params is not None:
            params, state = {}, {}
            for name in out.order:
                src = mapping.get(name)
                if src is None:
                    params[name] = _copy(net.params[name])
                    state[name] = _copy(net.state[name])
                else:
                    params[name] = _fused_params(net.params[src["conv"]],
                                                 net.params[src["bn"]])
                    state[name] = _copy(net.state[src["bn"]])
            out.set_params(params, state)
        return out
    raise TypeError(f"fuse_network() expects a network, got {type(net).__name__}")


# ---------------------------------------------------------------- fold_bn
def _bn_scale_shift(bn, bn_params: dict, bn_state: dict):
    """Inference-mode per-channel (scale, shift) of a BatchNormalization or
    a fused block, from its running stats, in float32."""
    mean, var = bn_state["mean"].float(), bn_state["var"].float()
    if getattr(bn, "lock_gamma_beta", False):
        gamma, beta = torch.full_like(mean, bn.gamma), torch.full_like(mean, bn.beta)
    else:
        gamma, beta = bn_params["gamma"].float(), bn_params["beta"].float()
    scale = gamma * torch.rsqrt(var + bn.eps)
    return scale, beta - mean * scale


def _fold_head_params(layer, params: dict, scale, shift) -> dict:
    """A per-channel (scale, shift) folded into the head's parameters: into
    W's output-channel axis, or into the pointwise W_pw of a separable head
    (the depthwise stage is untouched)."""
    key = "W_pw" if isinstance(layer, (SeparableConvolution2D,
                                       FusedSeparableConvBNActivation)) else "W"
    w = params[key].detach().float()
    b = (params["b"].detach().float() if layer.has_bias
         else torch.zeros(w.shape[-1], dtype=torch.float32, device=w.device))
    out = {key: w * scale, "b": b * scale + shift}
    if key == "W_pw":
        out = {"W_dw": params["W_dw"].detach().float().clone(), **out}
    return out


_FOLDABLE_FUSED = (FusedConvBNActivation, FusedSeparableConvBNActivation,
                   FusedConv1DBNActivation)


def _unfuse_head(fl):
    """The BN-free head a folded fused block collapses into (with a bias:
    it takes the BN's shift)."""
    common = dict(
        name=fl.name, dropout=fl.dropout, remat=fl.remat, activation=fl.activation,
        weight_init=fl.weight_init, dist=fl.dist, bias_init=fl.bias_init, l1=fl.l1,
        l2=fl.l2, l1_bias=fl.l1_bias, l2_bias=fl.l2_bias, updater=fl.updater,
        gradient_normalization=fl.gradient_normalization,
        gradient_normalization_threshold=fl.gradient_normalization_threshold,
        constraints=fl.constraints, weight_noise=fl.weight_noise, n_in=fl.n_in,
        n_out=fl.n_out, kernel_size=fl.kernel_size, stride=fl.stride, padding=fl.padding,
        convolution_mode=fl.convolution_mode, has_bias=True)
    if isinstance(fl, FusedConvBNActivation):
        return ConvolutionLayer(dilation=fl.dilation, **common)
    if isinstance(fl, FusedSeparableConvBNActivation):
        return SeparableConvolution2D(depth_multiplier=fl.depth_multiplier, **common)
    return Convolution1DLayer(dilation=fl.dilation, **common)


def fold_bn(net):
    """Serving-time BN folding (the JAX package's ``fold_bn``): a new
    network of the same class, on the same device, whose inference output
    matches the BN-inference output within float tolerance and whose
    configuration holds no foldable BN. A BN not directly behind an
    identity-activation head stays. Updater state starts anew."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if net.params is None:
        net.init()
    with torch.no_grad():
        if isinstance(net, MultiLayerNetwork):
            return _fold_bn_multilayer(net)
        if isinstance(net, ComputationGraph):
            return _fold_bn_graph(net)
    raise TypeError(f"fold_bn() expects a network, got {type(net).__name__}")


def _fold_bn_multilayer(net):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    pres = dict(net.conf.input_preprocessors or {})
    layers = list(net.conf.layers)
    new_layers, new_params, new_state = [], [], []
    new_pres: Dict[int, object] = {}
    i = 0
    while i < len(layers):
        l = layers[i]
        if i in pres:
            new_pres[len(new_layers)] = pres[i]
        if (_head_matchable(l) and i + 1 < len(layers)
                and isinstance(layers[i + 1], BatchNormalization) and (i + 1) not in pres):
            scale, shift = _bn_scale_shift(layers[i + 1], net.params[i + 1], net.state[i + 1])
            new_layers.append(dataclasses.replace(l, has_bias=True))
            new_params.append(_fold_head_params(l, net.params[i], scale, shift))
            new_state.append({})
            i += 2
            continue
        if isinstance(l, _FOLDABLE_FUSED) and not getattr(l, "residual", False):
            scale, shift = _bn_scale_shift(l, net.params[i], net.state[i])
            new_layers.append(_unfuse_head(l))
            new_params.append(_fold_head_params(l, net.params[i], scale, shift))
            new_state.append({})
        else:
            new_layers.append(l)
            new_params.append(_copy(net.params[i]))
            new_state.append(_copy(net.state[i]))
        i += 1
    conf = dataclasses.replace(net.conf, layers=tuple(new_layers),
                               input_preprocessors=new_pres or None)
    return MultiLayerNetwork(conf, net.device).set_params(new_params, new_state)


def _fold_bn_graph(net):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    vertices = dict(net.conf.vertices)
    outputs = list(net.conf.network_outputs)
    params = {n: _copy(p) for n, p in net.params.items()}
    state = {n: _copy(s) for n, s in net.state.items()}
    # fused blocks first: non-residual ones fold in place, residual ones
    # expand into conv -> add -> activation, the activation keeping the name
    for name in list(vertices):
        obj, ins = vertices[name]
        if not isinstance(obj, _FOLDABLE_FUSED):
            continue
        scale, shift = _bn_scale_shift(obj, params[name], state[name])
        if not getattr(obj, "residual", False):
            vertices[name] = (_unfuse_head(obj), ins)
            params[name] = _fold_head_params(obj, params[name], scale, shift)
            state[name] = {}
            continue
        conv = dataclasses.replace(_unfuse_head(obj), activation="identity")
        conv_name, add_name = f"{name}.fold_conv", f"{name}.fold_add"
        while conv_name in vertices:
            conv_name += "_"
        while add_name in vertices:
            add_name += "_"
        vertices[conv_name] = (conv, (ins[0],))
        vertices[add_name] = (ElementWiseVertex(op="add"), (conv_name, ins[1]))
        vertices[name] = (ActivationLayer(activation=obj.activation), (add_name,))
        params[conv_name] = _fold_head_params(obj, params[name], scale, shift)
        state[conv_name] = {}
        params[add_name], state[add_name] = {}, {}
        params[name], state[name] = {}, {}

    changed = True
    while changed:
        changed = False
        consumers: Dict[str, List[str]] = {}
        for n, (_, ins) in vertices.items():
            for inp in ins:
                consumers.setdefault(inp, []).append(n)
        for cname in list(vertices):
            cobj, cins = vertices[cname]
            if not _head_matchable(cobj):
                continue
            if cname in outputs or len(consumers.get(cname, ())) != 1:
                continue
            bname = consumers[cname][0]
            bobj, bins = vertices[bname]
            if not isinstance(bobj, BatchNormalization) or bins != (cname,):
                continue
            if bname in outputs:
                continue
            scale, shift = _bn_scale_shift(bobj, params[bname], state[bname])
            # the folded head takes the BN's name: downstream references hold
            vertices[bname] = (dataclasses.replace(cobj, has_bias=True), cins)
            params[bname] = _fold_head_params(cobj, params[cname], scale, shift)
            state[bname] = {}
            for d in (vertices, params, state):
                d.pop(cname)
            changed = True
            break
    out = ComputationGraph(dataclasses.replace(net.conf, vertices=vertices), net.device)
    return out.set_params({n: params[n] for n in out.order},
                          {n: state[n] for n in out.order})


# --------------------------------------------- saved-set measurement
def _labels_meta(out_layer, out_type, minibatch: int):
    """Float32 meta labels for an output layer (the JAX package's
    ``_labels_struct``)."""
    n_out = getattr(out_layer, "n_out", 0) or out_type.flat_size()
    if out_type.kind in ("rnn", "cnn1d"):
        t = out_type.timeseries_length or 16
        return torch.empty((minibatch, t, n_out), dtype=torch.float32, device="meta")
    return torch.empty((minibatch, n_out), dtype=torch.float32, device="meta")


def meta_network(conf, minibatch: int, augmentation=None):
    """``(net, params, state, inputs, labels)`` for one train step of
    ``conf`` on the meta device: a network whose device is ``meta``, its
    parameters and state from each layer's init there, and zero-cost
    inputs and labels of ``minibatch`` rows. Dropout and augmentation draw
    from CPU generators, which the meta device accepts."""
    from deeplearning4j_tpu_torch.analysis.validation import (_input_struct, _is_index_layer,
                                                              _meta_net, meta_init)
    from deeplearning4j_tpu_torch.nn.conf.layers import Layer
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if isinstance(conf, MultiLayerConfiguration):
        if conf.input_type is None:
            raise ValueError("training_activation_bytes needs an input_type")
        net = _meta_net(MultiLayerNetwork, conf)
        types = conf.layer_input_types()
        params, state = [], []
        for layer, it in zip(net.layers, types):
            p, st = meta_init(layer, it)
            params.append(p)
            state.append(st)
        inputs = _input_struct(conf.input_type, minibatch, _is_index_layer(net.layers[0]))
        labels = _labels_meta(net.layers[-1], net.layers[-1].output_type(types[-1]),
                              minibatch)
    elif isinstance(conf, ComputationGraphConfiguration):
        net = _meta_net(ComputationGraph, conf)
        params, state = {}, {}
        for name in net.order:
            obj, _ = net.vertices[name]
            if isinstance(obj, Layer):
                params[name], state[name] = meta_init(obj, net.vertex_input_types[name][0])
            else:
                params[name], state[name] = {}, {}
        inputs = []
        for ni, it in zip(conf.network_inputs, conf.input_types):
            cons = [conf.vertices[n][0] for n, (_, ins) in conf.vertices.items() if ni in ins]
            idx = any(isinstance(c, Layer) and _is_index_layer(c) for c in cons)
            inputs.append(_input_struct(it, minibatch, idx))
        out_types = conf.vertex_output_types()
        labels = [_labels_meta(conf.vertices[o][0], out_types[o], minibatch)
                  for o in conf.network_outputs]
    else:
        raise TypeError(f"expected a network configuration, got {type(conf).__name__}")
    net._gen, net._aug_gen = torch.Generator(), torch.Generator()
    net.augmentation = augmentation
    return net, params, state, inputs, labels


class _SavedSet:
    """Bytes of the distinct storages a pack hook sees."""

    def __init__(self):
        self.storages: Dict[int, int] = {}

    def pack(self, t):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            self.storages.setdefault(st._cdata, int(st.nbytes()))
        return t

    def nbytes(self) -> int:
        return sum(self.storages.values())


def training_activation_bytes(conf, minibatch: int = 32, augmentation=None) -> int:
    """Bytes the backward of one train-mode loss forward keeps (module
    docstring), measured on the meta device. Fusion and ``remat=`` change
    it as they change the step's device memory; ``augmentation``
    (``datasets/augment.ImageAugmentation``) runs in the measured step."""
    net, params, state, inputs, labels = meta_network(conf, minibatch, augmentation)
    leaves = tree_map(lambda v: v.requires_grad_(True) if v.is_floating_point() else v,
                      params)
    saved = _SavedSet()
    with torch.autograd.graph.saved_tensors_hooks(saved.pack, lambda t: t):
        net._loss_fn(leaves, state, inputs, labels, net._gen, None, None)
    return saved.nbytes()
