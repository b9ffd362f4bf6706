"""The middle hop: clean itself, but it pulls in hostutil."""

import torch

from . import hostutil


def standardize(x):
    scale = hostutil.drift_scale(x)
    return (x - torch.mean(x)) * scale
