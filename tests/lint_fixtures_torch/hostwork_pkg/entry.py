"""The step root. Its own body is clean — the hazard is two call hops
away, which is exactly what the per-file DLT002 cannot see."""

import torch

from . import stats
from deeplearning4j_tpu_torch.perf.compile_watch import CompileWatch


def predict(x):
    return stats.standardize(x) * torch.full((), 2.0)


watch = CompileWatch("hostwork")
step = watch.wrap(predict, "predict")
