"""The deep helper: a global-RNG draw and host numpy in a mixed
host/device function, two call hops from the step root entry.predict."""

import math

import numpy as np
import torch


def drift_scale(x):
    started = torch.rand(())
    base = np.asarray(x)
    return started - math.log(base.shape[0])
