"""Calibration: drive a representative batch stream through the network's
inference forward and record per-layer activation ranges (counterpart of
``deeplearning4j_tpu/quant/calibrate.py``).

The input of each quantizable layer is read out of the forward's
activations, through the layer's input preprocessor, exactly as
``layer.apply`` sees it. Per batch, the device reduces each input to
``[min, max, percentile(|x|, p)]`` and the host observers aggregate across
batches. The :class:`CalibrationRecord` is the JAX package's: the same JSON
(sorted keys), so a record written by either package is read by the other.

``percentile(|x|, 100)`` (the ``minmax`` observer) is computed as a max.
Other percentiles sort and interpolate linearly, as ``jnp.percentile``
does; ``torch.quantile`` is not used because it refuses inputs above
2**24 elements, and VGG16's conv activations at batch 16 hold about 51 M.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.quant.observers import make_observer

__all__ = ["CalibrationRecord", "calibrate", "signature_of"]

CALIBRATION_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class CalibrationRecord:
    """Per-layer activation ranges + scales for one concrete serving graph.
    ``signature`` is a tuple of ``(slot_key, source_layer_class, n_out)``
    in forward order (``slot_key`` is ``"layer<i>"``); ``ranges`` maps slot
    key to ``{"min", "max", "amax", "scale", "zero_point"}``."""

    model_type: str
    observer: str
    percentile: Optional[float]
    batches: int
    signature: Tuple[Tuple[str, str, int], ...]
    ranges: Dict[str, Dict[str, float]]

    def scale(self, key: str) -> float:
        return float(self.ranges[key]["scale"])

    def to_dict(self) -> dict:
        return {
            "format_version": CALIBRATION_FORMAT_VERSION,
            "model_type": self.model_type,
            "observer": self.observer,
            "percentile": self.percentile,
            "batches": self.batches,
            "signature": [list(p) for p in self.signature],
            "ranges": self.ranges,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationRecord":
        return cls(
            model_type=d["model_type"],
            observer=d["observer"],
            percentile=d.get("percentile"),
            batches=int(d.get("batches", 0)),
            signature=tuple((str(p[0]), str(p[1]), int(p[2]))
                            for p in d["signature"]),
            ranges={str(k): dict(v) for k, v in d["ranges"].items()},
        )

    def to_json(self) -> str:
        # sorted keys: two equal records serialize to IDENTICAL bytes
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CalibrationRecord":
        return cls.from_dict(json.loads(s))


def _quant_slots(net) -> List[Tuple[str, object]]:
    """(slot_key, layer) for every quantizable layer, in forward order."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.quant.lowering import quantizable_kind

    if not isinstance(net, MultiLayerNetwork):
        raise TypeError(f"calibrate() expects a MultiLayerNetwork, got "
                        f"{type(net).__name__}")
    return [(f"layer{i}", l) for i, l in enumerate(net.layers)
            if quantizable_kind(l) is not None]


def signature_of(net) -> Tuple[Tuple[str, str, int], ...]:
    return tuple((k, type(l).__name__, int(l.n_out or 0))
                 for k, l in _quant_slots(net))


def _stat_vec(x: torch.Tensor, p: float) -> torch.Tensor:
    """[min, max, percentile(|x|, p)] of one activation tensor, f32."""
    xf = x.reshape(-1).to(torch.float32)
    a = xf.abs()
    if p >= 100.0:
        pct = a.max()
    else:
        v = torch.sort(a).values
        pos = (p / 100.0) * (v.numel() - 1)
        lo = int(pos)
        hi = min(lo + 1, v.numel() - 1)
        pct = v[lo] + (v[hi] - v[lo]) * (pos - lo)
    return torch.stack([xf.min(), xf.max(), pct])


def _features(item):
    return getattr(item, "features", item)


@torch.inference_mode()
def calibrate(net, data, observer: str = "minmax",
              percentile: float = 99.99, max_batches: Optional[int] = None,
              fold: bool = True) -> CalibrationRecord:
    """Measure per-layer activation ranges over a representative stream.

    ``net``: a MultiLayerNetwork (initialized or not); it runs on its own
    device. ``data``: an iterable of feature arrays (numpy or tensors) or
    objects with a ``features`` attribute. ``fold=True`` measures on the
    BN-folded serving graph (``perf.fusion.fold_bn``), the graph
    ``quantize`` lowers."""
    from deeplearning4j_tpu_torch.quant.lowering import _fold_bn

    if net.params is None:
        net.init()
    net = _fold_bn(net, fold)
    slots = _quant_slots(net)
    if not slots:
        raise ValueError(
            "calibrate(): no quantizable layer (dense/conv/output) in this "
            "network — nothing to measure")
    obs = {k: make_observer(observer, percentile) for k, _ in slots}
    p = next(iter(obs.values())).percentile
    idxs = [int(k[len("layer"):]) for k, _ in slots]
    n = 0
    for item in data:
        if max_batches is not None and n >= max_batches:
            break
        x = net._as_input(_features(item))
        acts = net._forward(net.params, net.state, x, False)[0]
        vecs = []
        for i in idxs:
            xin = x if i == 0 else acts[i - 1]
            if i in net._pre:
                xin, _ = net._pre[i].apply(xin, None)
            vecs.append(_stat_vec(xin, p))
        # one host transfer per batch, 3 floats per slot
        stats = torch.stack(vecs).cpu().tolist()
        for (k, _), (mn, mx, pct) in zip(slots, stats):
            obs[k].update(float(mn), float(mx), float(pct))
        n += 1
    if n == 0:
        raise ValueError("calibrate(): empty batch stream")
    return CalibrationRecord(
        model_type=type(net).__name__,
        observer=observer,
        percentile=(float(percentile) if observer == "percentile" else None),
        batches=n,
        signature=signature_of(net),
        ranges={k: o.entry() for k, o in obs.items()},
    )
