"""Numerical gradient checking (counterpart of
``deeplearning4j_tpu/utils/gradient_check.py``; reference
gradientcheck/GradientCheckUtil.java checkGradients).

The contract is the reference's: float64, central finite differences with
``eps``, relative error ``|a - n| / max(|a|, |n|)`` held to
``max_rel_error`` unless both are below ``min_abs_error``. The analytic
gradient is autograd of the loss the training step uses
(``net._loss_fn``), on float64 copies of the parameters on the CPU, so the
network's own parameters are left as they are. Dropout must be off.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.tree import leaf_grads, tree_leaves, tree_map


def _float64(a):
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                                      dtype=np.float64))


def check_gradients(net, ds, eps: float = 1e-6, max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8, max_params_to_check: int = 4096,
                    seed: int = 12345, print_failures: bool = True) -> bool:
    """Finite-difference check of d(loss)/d(params) for a
    ``MultiLayerNetwork`` on one ``DataSet``; True when every checked
    parameter passes. At most ``max_params_to_check`` parameters, drawn
    from a numpy generator seeded with ``seed``, are checked."""
    params = tree_map(lambda v: v.detach().to("cpu", torch.float64).requires_grad_(True),
                      net.params)
    state = tree_map(lambda v: v.detach().to("cpu", torch.float64), net.state)
    x, y = _float64(ds.features), _float64(ds.labels)
    fm, lm = _float64(ds.features_mask), _float64(ds.labels_mask)

    def loss():
        return net._loss_fn(params, state, x, y, None, fm, lm)[0]

    leaves = tree_leaves(params)
    analytic = torch.cat([g.reshape(-1) for g in tree_leaves(leaf_grads(loss(), params))])
    n = analytic.numel()
    idxs = (np.arange(n) if n <= max_params_to_check
            else np.random.default_rng(seed).choice(n, max_params_to_check, replace=False))
    sizes = np.cumsum([0] + [v.numel() for v in leaves])
    failures, max_err = 0, 0.0
    with torch.no_grad():
        for i in idxs:
            j = int(np.searchsorted(sizes, i, side="right")) - 1
            flat = leaves[j].view(-1)
            k = int(i - sizes[j])
            orig = float(flat[k])
            flat[k] = orig + eps
            up = float(loss())
            flat[k] = orig - eps
            down = float(loss())
            flat[k] = orig
            numeric = (up - down) / (2 * eps)
            a = float(analytic[i])
            denom = max(abs(a), abs(numeric))
            rel = 0.0 if denom == 0 else abs(a - numeric) / denom
            max_err = max(max_err, rel)
            if rel > max_rel_error and not (abs(a) < min_abs_error
                                            and abs(numeric) < min_abs_error):
                failures += 1
                if print_failures and failures <= 10:
                    print(f"  param[{i}]: analytic={a:.8g} numeric={numeric:.8g} "
                          f"rel={rel:.3g}")
    if print_failures and failures:
        print(f"gradient check: {failures}/{len(idxs)} failures, max rel err {max_err:.3g}")
    return failures == 0
