"""YOLOv2 detection output layer (counterpart of
``deeplearning4j_tpu/nn/conf/objdetect.py``: ``Yolo2OutputLayer``,
``DetectedObject``, ``get_predicted_objects``).

Layout is NHWC: the layer's input is (mb, H, W, B * (5 + C)), and labels
are (mb, H, W, 4 + C), the box corners [x1, y1, x2, y2] in grid units then
a one-hot class (all zero: no object in the cell). The loss is the JAX
package's expression step for step, in the same order of operations: the
responsible box is an argmax over the IoU, so the IoU must round as the
reference rounds it, and ties take the lower box index (``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does). The networks cast the
layer's input to float32 before the loss.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.layers import Layer, register_layer


def _split_grid(x, n_boxes: int):
    """(mb, H, W, B * (5 + C)) -> (mb, H, W, B, 5 + C)."""
    mb, h, w, d = x.shape
    return x.reshape(mb, h, w, n_boxes, d // n_boxes)


@register_layer
@dataclasses.dataclass(frozen=True)
class Yolo2OutputLayer(Layer):
    """YOLOv2 loss layer. ``boxes``: the (w, h) anchor priors in grid
    units; ``lambda_coord`` / ``lambda_no_obj`` weigh the position and
    no-object confidence terms (reference defaults 5 and 0.5)."""

    boxes: Tuple[Tuple[float, float], ...] = ()
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def is_output_layer(self):
        return True

    def input_kind(self):
        return "cnn"

    def regularizable(self):
        return ()

    def pre_output(self, params, x):
        return x

    def _priors(self, t):
        return torch.tensor(self.boxes, dtype=t.dtype, device=t.device)

    def output_activations(self, preout):
        """sigmoid xy and confidence, prior * exp wh, softmax classes, in
        the input's layout."""
        t = _split_grid(preout, len(self.boxes))
        out = torch.cat([torch.sigmoid(t[..., 0:2]), self._priors(t) * torch.exp(t[..., 2:4]),
                         torch.sigmoid(t[..., 4:5]), torch.softmax(t[..., 5:], dim=-1)], dim=-1)
        return out.reshape(preout.shape)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.output_activations(x), state

    def _per_example(self, labels, preout):
        """Each example's summed loss terms, (mb,)."""
        b = len(self.boxes)
        t = _split_grid(preout, b)
        H, W = t.shape[1], t.shape[2]
        priors = self._priors(t)

        cls_labels = labels[..., 4:]
        obj = (torch.sum(cls_labels, -1) > 0).to(t.dtype)

        tl = labels[..., 0:2]
        br = labels[..., 2:4]
        center = 0.5 * (tl + br)
        center_in_cell = center - torch.floor(center)
        label_wh = br - tl
        label_wh_sqrt = torch.sqrt(torch.clamp_min(label_wh, 0.0))

        pred_xy = torch.sigmoid(t[..., 0:2])
        pred_wh = priors * torch.exp(t[..., 2:4])
        pred_wh_sqrt = torch.sqrt(pred_wh)
        pred_conf = torch.sigmoid(t[..., 4])

        gx = torch.arange(W, dtype=t.dtype, device=t.device)[None, None, :, None]
        gy = torch.arange(H, dtype=t.dtype, device=t.device)[None, :, None, None]
        grid = torch.stack([gx.expand(1, H, W, 1), gy.expand(1, H, W, 1)], dim=-1)
        pred_center = pred_xy + grid
        p_tl = pred_center - 0.5 * pred_wh
        p_br = pred_center + 0.5 * pred_wh

        l_tl = tl[:, :, :, None, :]
        l_br = br[:, :, :, None, :]
        inter_tl = torch.maximum(p_tl, l_tl)
        inter_br = torch.minimum(p_br, l_br)
        inter_wh = torch.clamp_min(inter_br - inter_tl, 0.0)
        inter = inter_wh[..., 0] * inter_wh[..., 1]
        area_p = pred_wh[..., 0] * pred_wh[..., 1]
        area_l = (label_wh[..., 0] * label_wh[..., 1])[:, :, :, None]
        union = area_p + area_l - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                          torch.zeros((), dtype=t.dtype, device=t.device))

        responsible = torch.nn.functional.one_hot(torch.argmax(iou, -1), b).to(t.dtype)
        m_obj = responsible * obj[..., None]
        m_noobj = 1.0 - m_obj
        conf_target = iou.detach() * m_obj

        def per_ex(v):
            return torch.sum(v.reshape(v.shape[0], -1), -1)

        pos = per_ex(m_obj[..., None] * (pred_xy - center_in_cell[:, :, :, None, :]) ** 2)
        size = per_ex(m_obj[..., None] * (pred_wh_sqrt - label_wh_sqrt[:, :, :, None, :]) ** 2)
        conf = (per_ex(m_obj * (pred_conf - conf_target) ** 2)
                + self.lambda_no_obj * per_ex(m_noobj * (pred_conf - conf_target) ** 2))
        cls_pred = torch.softmax(t[..., 5:], dim=-1)
        cls_loss = per_ex(m_obj[..., None] * (cls_pred - cls_labels[:, :, :, None, :]) ** 2)
        return self.lambda_coord * (pos + size) + conf + cls_loss

    def compute_score(self, labels, preout, mask=None):
        """The YOLOv2 loss: the summed terms over the minibatch size."""
        return torch.sum(self._per_example(labels, preout)) / preout.shape[0]

    def compute_score_array(self, labels, preout, mask=None):
        return self._per_example(labels, preout)


class DetectedObject:
    """One decoded detection: center and size in grid units, confidence
    and class distribution (reference DetectedObject)."""

    def __init__(self, example: int, cx: float, cy: float, w: float, h: float,
                 confidence: float, class_probs: np.ndarray):
        self.example = example
        self.center_x = cx
        self.center_y = cy
        self.width = w
        self.height = h
        self.confidence = confidence
        self.class_probs = class_probs

    @property
    def predicted_class(self) -> int:
        return int(np.argmax(self.class_probs))

    def top_left(self):
        return (self.center_x - self.width / 2, self.center_y - self.height / 2)

    def bottom_right(self):
        return (self.center_x + self.width / 2, self.center_y + self.height / 2)

    def __repr__(self):
        return (f"DetectedObject(ex={self.example}, cls={self.predicted_class},"
                f" conf={self.confidence:.3f}, xywh=({self.center_x:.2f},"
                f"{self.center_y:.2f},{self.width:.2f},{self.height:.2f}))")


def get_predicted_objects(activations, n_boxes: int,
                          threshold: float = 0.5) -> List[DetectedObject]:
    """The detections of YOLO activations (``output_activations``' result,
    a tensor or an array) at or above ``threshold`` confidence (reference
    YoloUtils.getPredictedObjects), in (example, y, x, box) order."""
    if isinstance(activations, torch.Tensor):
        activations = activations.detach().float().cpu().numpy()
    a = np.asarray(activations)
    mb, H, W, d = a.shape
    a5 = a.reshape(mb, H, W, n_boxes, d // n_boxes)
    out: List[DetectedObject] = []
    for e, y, x, bi in zip(*np.where(a5[..., 4] >= threshold)):
        v = a5[e, y, x, bi]
        out.append(DetectedObject(int(e), float(x + v[0]), float(y + v[1]), float(v[2]),
                                  float(v[3]), float(v[4]), v[5:].copy()))
    return out
