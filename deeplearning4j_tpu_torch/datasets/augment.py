"""On-device data augmentation: crop, flip and normalize of an NHWC batch
inside the train step (counterpart of ``deeplearning4j_tpu/datasets/augment.py``).

Host-side augmentation pays a host pass over every image and the copy of
the augmented result; on the card the same ops are small next to the
convolutions. ``ImageAugmentation`` is a frozen configuration whose
``apply(x, generator)`` runs on the batch's device, drawing from a
``torch.Generator`` on that device (the network's augmentation generator,
seeded from ``conf.seed`` and checkpointed beside the dropout generator),
so an epoch is deterministic given the seed and resume replays it bitwise.
No host read happens: the draws stay on the card.

``apply_with(x, oy, ox, flip)`` is the pure part, which takes the draws:
per-example crop offsets and flip flags. JAX draws with threefry and the
port with Philox, so the two packages agree given the same draws, not the
same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ImageAugmentation"]


@dataclasses.dataclass(frozen=True)
class ImageAugmentation:
    """Random crop / horizontal flip / per-channel normalize of NHWC
    batches.

    ``crop_padding``: zero-pad H and W by this much, then take a random
    H x W crop per example (the CIFAR recipe); 0 disables.
    ``flip_prob``: per-example probability of a horizontal (width-axis)
    flip; 0 disables.
    ``mean``/``std``: per-channel ``(x - mean) / std`` after the geometric
    ops; None disables."""

    crop_padding: int = 0
    flip_prob: float = 0.0
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.crop_padding < 0:
            raise ValueError(f"crop_padding must be >= 0, got {self.crop_padding}")
        if not 0.0 <= self.flip_prob <= 1.0:
            raise ValueError(f"flip_prob must be in [0, 1], got {self.flip_prob}")
        if (self.mean is None) != (self.std is None):
            raise ValueError("mean and std must be set together")

    def to_dict(self) -> dict:
        return {
            "crop_padding": self.crop_padding,
            "flip_prob": self.flip_prob,
            "mean": None if self.mean is None else list(self.mean),
            "std": None if self.std is None else list(self.std),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ImageAugmentation":
        return cls(
            crop_padding=int(d.get("crop_padding", 0)),
            flip_prob=float(d.get("flip_prob", 0.0)),
            mean=None if d.get("mean") is None else tuple(float(v) for v in d["mean"]),
            std=None if d.get("std") is None else tuple(float(v) for v in d["std"]),
        )

    @staticmethod
    def _check(x):
        if x.dim() != 4:
            raise ValueError("ImageAugmentation.apply expects NHWC (batch, h, w, c); "
                             f"got rank-{x.dim()} input")

    def draws(self, x, generator: torch.Generator):
        """The per-example draws for ``x``: crop offsets ``oy``, ``ox`` in
        [0, 2 * crop_padding] and flip flags, on ``x``'s device (None for a
        disabled op)."""
        self._check(x)
        n = int(x.shape[0])
        oy = ox = flip = None
        if self.crop_padding:
            hi = 2 * int(self.crop_padding) + 1
            oy = torch.randint(0, hi, (n,), generator=generator, device=x.device)
            ox = torch.randint(0, hi, (n,), generator=generator, device=x.device)
        if self.flip_prob:
            flip = torch.rand(n, generator=generator, device=x.device) < self.flip_prob
        return oy, ox, flip

    def apply(self, x, generator: torch.Generator):
        """Augment one NHWC batch with draws from ``generator`` (on the
        batch's device). Shape-preserving."""
        return self.apply_with(x, *self.draws(x, generator))

    def apply_with(self, x, oy=None, ox=None, flip=None):
        """The augmentation at given draws: the crop is one gather from the
        zero-padded batch at each example's (oy, ox); the flip a
        ``torch.where`` over the width-reversed batch; then the
        normalization."""
        self._check(x)
        n, h, w, _ = x.shape
        if self.crop_padding:
            p = int(self.crop_padding)
            padded = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
            dev = x.device
            rows = oy.to(dev, torch.long)[:, None] + torch.arange(h, device=dev)[None, :]
            cols = ox.to(dev, torch.long)[:, None] + torch.arange(w, device=dev)[None, :]
            x = padded[torch.arange(n, device=dev)[:, None, None], rows[:, :, None],
                       cols[:, None, :]]
        if self.flip_prob:
            x = torch.where(flip.to(x.device, torch.bool)[:, None, None, None],
                            x.flip(2), x)
        if self.mean is not None:
            mean, std = self._moments(x.device, x.dtype)
            x = (x - mean) / std
        return x

    def _moments(self, device, dtype):
        """``mean`` and ``std`` as tensors on ``device``, made once: a copy
        from the host a step would wait on the host."""
        cache = self.__dict__.setdefault("_moment_cache", {})
        key = (device, dtype)
        if key not in cache:
            cache[key] = (torch.tensor(self.mean, dtype=dtype).to(device),
                          torch.tensor(self.std, dtype=dtype).to(device))
        return cache[key]
