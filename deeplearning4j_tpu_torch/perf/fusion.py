"""Conv→BN→Activation(→residual add) fusion (counterpart of
``deeplearning4j_tpu/perf/fusion.py``: ``fuse``, ``fuse_network``).

``fuse(conf)`` pattern-matches ConvolutionLayer → BatchNormalization →
ActivationLayer (→ ElementWiseVertex add → ActivationLayer) chains in
``MultiLayerConfiguration`` stacks and ``ComputationGraphConfiguration``
DAGs and replaces each with a ``FusedConvBNActivation`` block. The rewrite
is the JAX package's step for step, so both packages give the same fused
configuration (vertex names, order, fields) and the same parameter mapping:
the fused vertex keeps the last matched vertex's name, the conv's layer
name, and takes the conv's params plus the BN's gamma/beta and running
stats. Only 2-D convolution heads are ported; the separable and 1-D heads
of the JAX package are not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.convolutional import (ConvolutionLayer,
                                                            FusedConvBNActivation)
from deeplearning4j_tpu_torch.nn.conf.graph import (ComputationGraphConfiguration,
                                                    ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.normalization import BatchNormalization

__all__ = ["fuse", "fuse_network"]


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


def _head_matchable(layer) -> bool:
    return isinstance(layer, ConvolutionLayer) and layer.activation == "identity"


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


def _make_fused(conv: ConvolutionLayer, bn: BatchNormalization,
                activation: str, residual: bool = False,
                name: Optional[str] = None) -> FusedConvBNActivation:
    return FusedConvBNActivation(
        name=name if name is not None else conv.name,
        dropout=conv.dropout,
        remat=conv.remat,
        activation=activation,
        weight_init=conv.weight_init,
        dist=conv.dist,
        bias_init=conv.bias_init,
        l1=conv.l1, l2=conv.l2,
        l1_bias=conv.l1_bias, l2_bias=conv.l2_bias,
        updater=conv.updater,
        gradient_normalization=conv.gradient_normalization,
        gradient_normalization_threshold=conv.gradient_normalization_threshold,
        constraints=conv.constraints,
        weight_noise=conv.weight_noise,
        n_in=conv.n_in, n_out=conv.n_out,
        kernel_size=conv.kernel_size, stride=conv.stride,
        padding=conv.padding, convolution_mode=conv.convolution_mode,
        dilation=conv.dilation, has_bias=conv.has_bias,
        decay=bn.decay, eps=bn.eps, gamma=bn.gamma, beta=bn.beta,
        residual=residual)


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
            elif (isinstance(nobj, ElementWiseVertex)
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
    return {k: v.detach().clone() for k, v in d.items()}


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
