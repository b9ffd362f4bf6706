"""Compressed gradients with error feedback (counterpart of
``deeplearning4j_tpu/parallel/compress.py``): threshold, top-k, int8 and
1-bit encodings, the same schemes, configs, state tree and byte
accounting, so a checkpoint of a compressed run restores in either
package.

One step of a network with a scheme attached runs (``nn/training.py``):
gradients, their mean over the data group when one is active, then
:meth:`GradientCompression.apply`, then each layer's gradient
normalization and updater. ``apply`` is ``decode(encode(g + residual))``
per leaf with the error-feedback residual ``residual' = (g + residual) -
decoded``, in float32, and the accounting: cumulative dense and wire
bytes, the last step's ratio and the residual's L2 norm. Every number
of the state is a tensor on the model's device and the step reads none
of them on the host; :func:`compression_stats` reads them off the step
path.

The state tree is the JAX package's: ``{"residual": params-shaped tree
or None, "ctrl": {"tau"} for the adaptive threshold, "acc": {steps,
dense_bytes, wire_bytes, last_wire_bytes, last_ratio, residual_norm}}``.
Leaves are visited in ``jax.tree_util``'s flatten order (dict keys
sorted, lists by index), so the sums over leaves add in the reference's
order.

The encodings work on the reduced gradient, as the JAX step's
compression works on GSPMD's global gradient; the wire bytes are what a
wire format of the scheme would move, the accounting the JAX package
keeps. A frozen (``NoOp``) layer's gradient is zero in the port (it is
never taken), so its leaves add nothing to τ's encoded count or to the
residual.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

import torch

__all__ = [
    "GradientCompression", "ThresholdCompression", "TopKCompression",
    "Int8Compression", "OneBitCompression", "enable_grad_compression",
    "ensure_compress_state", "measure_compression_overhead",
    "compression_stats", "restore_compress_state", "compress_state_arrays",
]

log = logging.getLogger(__name__)

_SCHEME_REGISTRY = {}

# fixed per-leaf framing of the accounted wire formats (DL4J's threshold
# encoding carries a 4-int header)
_HEADER_BYTES = 16.0

_ACC_KEYS = ("steps", "dense_bytes", "wire_bytes", "last_wire_bytes",
             "last_ratio", "residual_norm")


def register_scheme(cls):
    _SCHEME_REGISTRY[cls.__name__] = cls
    return cls


def _leaves(tree, prefix=""):
    """``[(path, leaf)]`` in ``jax.tree_util``'s flatten order; a None
    subtree has no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(tree, values: dict, prefix=""):
    """``tree``'s structure with the leaf at each path from ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, values, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return values[prefix]


def _scalar(v: float, device) -> torch.Tensor:
    return torch.full((), float(v), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class GradientCompression:
    """Base config: error feedback and accounting; a scheme gives
    ``_encode_decode`` (one leaf) and optionally ``_init_ctrl`` /
    ``_update_ctrl`` (controller state, the adaptive threshold).

    ``error_feedback=True`` (default) carries the residual, so the lossy
    update stays unbiased over time; without it only stateless updaters
    are allowed (:func:`enable_grad_compression`)."""

    error_feedback: bool = True

    # ------------------------------------------------------------- config
    def to_config(self) -> dict:
        d = dataclasses.asdict(self)
        d["@scheme"] = type(self).__name__
        return d

    @staticmethod
    def from_config(d: dict) -> "GradientCompression":
        d = dict(d)
        name = d.pop("@scheme")
        cls = _SCHEME_REGISTRY.get(name)
        if cls is None:
            raise ValueError(f"unknown gradient-compression scheme {name!r} "
                             f"(known: {sorted(_SCHEME_REGISTRY)})")
        return cls(**d)

    # -------------------------------------------------------------- state
    def _init_ctrl(self, device) -> dict:
        return {}

    def _update_ctrl(self, ctrl: dict, nnz_total, n_total: int) -> dict:
        return ctrl

    def init_state(self, params, device=None) -> dict:
        """Zeros residual (float32, the parameters' shapes and device), the
        controller and the accumulators."""
        leaves = _leaves(params)
        if device is None:
            device = leaves[0][1].device if leaves else torch.device("cpu")
        residual = None
        if self.error_feedback:
            residual = _rebuild(params, {p: torch.zeros(a.shape, dtype=torch.float32,
                                                        device=a.device)
                                         for p, a in leaves})
        return {"residual": residual, "ctrl": self._init_ctrl(device),
                "acc": {k: _scalar(0.0, device) for k in _ACC_KEYS}}

    # ----------------------------------------------------------- encoding
    def _encode_decode(self, v, ctrl):
        """One float32 leaf -> (decoded leaf, wire bytes, nonzeros), the
        last two 0-d float32 tensors or Python floats."""
        raise NotImplementedError

    def apply(self, grads, state):
        """``(decoded gradient tree, new state)``; no host sync."""
        ctrl, acc = state["ctrl"], state["acc"]
        device = acc["steps"].device
        leaves = _leaves(grads)
        res = dict(_leaves(state["residual"])) if state["residual"] is not None else {}
        dec_leaves, new_res = {}, {}
        wire_total = _scalar(0.0, device)
        nnz_total = _scalar(0.0, device)
        n_total = 0
        dense_total = 0.0
        for path, g in leaves:
            v = g.float()
            r = res.get(path)
            if r is not None:
                v = v + r
            dec, wire, nnz = self._encode_decode(v, ctrl)
            wire_total = wire_total + wire
            nnz_total = nnz_total + nnz
            n_total += v.numel()
            dense_total += float(v.numel() * 4)
            if r is not None:
                new_res[path] = v - dec
            dec_leaves[path] = dec.to(g.dtype)
        new_ctrl = self._update_ctrl(ctrl, nnz_total, max(n_total, 1))
        residual = None
        rnorm = _scalar(0.0, device)
        if state["residual"] is not None:
            residual = _rebuild(grads, new_res)
            sq = _scalar(0.0, device)
            for _, r in _leaves(residual):
                sq = sq + torch.sum(r * r)
            rnorm = torch.sqrt(sq)
        new_acc = {
            "steps": acc["steps"] + 1.0,
            "dense_bytes": acc["dense_bytes"] + dense_total,
            "wire_bytes": acc["wire_bytes"] + wire_total,
            "last_wire_bytes": wire_total,
            # a tensor numerator: torch divides a Python number by a tensor
            # through the reciprocal, off by an ulp from the quotient
            "last_ratio": _scalar(dense_total, device) / torch.clamp_min(wire_total, 1.0),
            "residual_norm": rnorm,
        }
        return _rebuild(grads, dec_leaves), {"residual": residual, "ctrl": new_ctrl,
                                             "acc": new_acc}


@register_scheme
@dataclasses.dataclass(frozen=True)
class ThresholdCompression(GradientCompression):
    """DL4J's scheme: ``|v| >= tau`` encodes as ``sign(v) * tau``, the rest
    goes to the residual. The adaptive controller (DL4J's
    ``AdaptiveThresholdAlgorithm``) compares the step's global encoded
    fraction with ``target_sparsity`` and scales ``tau`` by
    ``adjust_rate`` outside a deadband, within hard bounds. Wire bytes:
    DL4J's dual encoding, a 4-byte index an encoded element or 2 bits an
    element, whichever is smaller, plus a header a tensor."""

    threshold: float = 1e-3
    adaptive: bool = True
    target_sparsity: float = 1e-3
    adjust_rate: float = 1.2
    deadband: float = 2.0
    min_threshold: float = 1e-6
    max_threshold: float = 1.0

    def _init_ctrl(self, device) -> dict:
        return {"tau": _scalar(self.threshold, device)}

    def _update_ctrl(self, ctrl, nnz_total, n_total):
        if not self.adaptive:
            return ctrl
        tau = ctrl["tau"]
        ratio = nnz_total / float(n_total)
        hi = self.target_sparsity * self.deadband
        lo = self.target_sparsity / self.deadband
        tau = torch.where(ratio > hi, tau * self.adjust_rate,
                          torch.where(ratio < lo, tau / self.adjust_rate, tau))
        return {"tau": torch.clamp(tau, self.min_threshold, self.max_threshold)}

    def _encode_decode(self, v, ctrl):
        tau = ctrl["tau"]
        mask = torch.abs(v) >= tau
        dec = torch.where(mask, torch.sign(v) * tau, torch.zeros((), device=v.device))
        nnz = mask.sum(dtype=torch.float32)
        sparse_bytes = 4.0 * nnz + _HEADER_BYTES
        bitmap_bytes = math.ceil(v.numel() / 16) * 4.0 + _HEADER_BYTES
        return dec, torch.clamp_max(sparse_bytes, bitmap_bytes), nnz


@register_scheme
@dataclasses.dataclass(frozen=True)
class TopKCompression(GradientCompression):
    """Per-tensor top-k by magnitude (Deep Gradient Compression): the
    ``ratio`` fraction of largest |v| passes with its values, the rest
    goes to the residual. Every entry tied with the k-th magnitude passes
    (never fewer than k, the same set whatever order a sort gives); a zero
    k-th magnitude passes nothing of zero. Wire: a 4-byte index and a
    4-byte value a kept element, plus a header."""

    ratio: float = 0.01
    min_k: int = 1

    def _encode_decode(self, v, ctrl):
        flat = v.reshape(-1)
        n = flat.numel()
        k = min(n, max(int(self.min_k), int(round(self.ratio * n))))
        a = torch.abs(flat)
        kth = torch.topk(a, k, sorted=True).values[k - 1]
        mask = (a >= kth) & (a > 0)
        dec = torch.where(mask, flat, torch.zeros((), device=v.device)).reshape(v.shape)
        nnz = mask.sum(dtype=torch.float32)
        return dec, 8.0 * nnz + _HEADER_BYTES, nnz


@register_scheme
@dataclasses.dataclass(frozen=True)
class Int8Compression(GradientCompression):
    """Symmetric round-to-nearest (half to even) onto [-127, 127] with a
    max-abs scale a tensor (default) or a ``chunk_size`` slice. Wire: a
    byte an element, 4 bytes a scale, plus a header."""

    chunk_size: Optional[int] = None

    def _encode_decode(self, v, ctrl):
        flat = v.reshape(-1)
        n = flat.numel()
        if self.chunk_size and n > int(self.chunk_size):
            c = int(self.chunk_size)
            pad = (-n) % c
            m = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, c)
            scale = torch.clamp_min(torch.abs(m).amax(dim=1, keepdim=True) / 127.0, 1e-30)
            q = torch.clamp(torch.round(m / scale), -127.0, 127.0)
            dec = (q * scale).reshape(-1)[:n].reshape(v.shape)
            n_scales = m.shape[0]
        else:
            scale = torch.clamp_min(torch.abs(flat).amax() / 127.0, 1e-30)
            q = torch.clamp(torch.round(flat / scale), -127.0, 127.0)
            dec = (q * scale).reshape(v.shape)
            n_scales = 1
        nnz = (q != 0).sum(dtype=torch.float32)
        return dec, float(n) + 4.0 * n_scales + _HEADER_BYTES, nnz


@register_scheme
@dataclasses.dataclass(frozen=True)
class OneBitCompression(GradientCompression):
    """1-bit SGD (Seide et al., 2014): each element's sign, decoded as the
    mean of its sign class (two float32 scales a tensor). Wire: a bit an
    element, two scales, plus a header."""

    def _encode_decode(self, v, ctrl):
        flat = v.reshape(-1)
        n = flat.numel()
        pos = flat >= 0
        posf = pos.float()
        cnt_p = posf.sum()
        mean_p = torch.sum(flat * posf) / torch.clamp_min(cnt_p, 1.0)
        mean_n = torch.sum(flat * (1.0 - posf)) / torch.clamp_min(n - cnt_p, 1.0)
        dec = torch.where(pos, mean_p, mean_n).reshape(v.shape)
        wire = math.ceil(n / 8) + 8.0 + _HEADER_BYTES
        return dec, float(wire), float(n)


# ------------------------------------------------------------------ wiring
def _model_updaters(model):
    ups = getattr(model, "_updaters", None)
    if ups is None:
        return []
    return list(ups.values()) if isinstance(ups, dict) else list(ups)


def enable_grad_compression(model, scheme: Optional[GradientCompression]):
    """Attach ``scheme`` to a ``MultiLayerNetwork`` / ``ComputationGraph``:
    its next step compresses. Raises, as the JAX package does, for a
    solver configuration (no step to compress), for
    ``error_feedback=False`` beside an updater with accumulating state,
    and for a model already compressed with another scheme. Registers
    ``obs.watch_grad_compression``, which reads the state at scrape time."""
    if scheme is None:
        return model
    existing = getattr(model, "grad_compression", None)
    if existing is not None:
        if existing != scheme:
            raise ValueError(
                f"model already has grad_compression={existing!r}; refusing to "
                f"switch to {scheme!r} mid-run: the carried residual and controller "
                "state belong to the old scheme (set model.grad_compression and "
                "model.compress_state to None first if the switch is intended)")
        return model
    from deeplearning4j_tpu_torch.nn.training import is_sgd_family
    from deeplearning4j_tpu_torch.optimize.updaters import NoOp, Sgd
    algo = getattr(model.conf, "optimization_algo", "stochastic_gradient_descent")
    if not is_sgd_family(algo):
        raise ValueError(
            f"grad_compression needs the minibatch SGD-family step; this network "
            f"is configured with optimization_algo={algo!r} (the solver path)")
    if not scheme.error_feedback:
        bad = sorted({type(u).__name__ for u in _model_updaters(model)
                      if not isinstance(u, (Sgd, NoOp))})
        if bad:
            raise ValueError(
                f"grad_compression(error_feedback=False) does not compose with "
                f"momentum/accumulator updaters ({', '.join(bad)}): their state "
                "would integrate the biased compression error every step. Keep "
                "error_feedback=True (the default) or switch those layers to Sgd")
    model.grad_compression = scheme
    from deeplearning4j_tpu_torch.obs.registry import get_registry, watch_grad_compression
    model._grad_compress_watch = watch_grad_compression(get_registry(), model)
    return model


def compress_state_arrays(state) -> dict:
    """``{path: tensor}`` of a compression state in the flatten order, keyed
    as ``compressState.npz`` keys it (``acc/steps``, ``ctrl/tau``,
    ``residual/0/W``)."""
    return dict(_leaves({k: v for k, v in state.items() if v is not None}))


def restore_compress_state(model, scheme_config, arrays=None, origin="checkpointed"):
    """Rebuild a scheme from its checkpoint config, enable it on ``model``
    and fill the zeros template from ``arrays`` (``{path: ndarray}``); a
    state that does not fit the template, or none, resets to zeros, as the
    JAX package's policy does."""
    import numpy as np
    scheme = GradientCompression.from_config(scheme_config)
    enable_grad_compression(model, scheme)
    template = scheme.init_state(model.params)
    model.compress_state = template
    if arrays:
        want = compress_state_arrays(template)
        try:
            vals = {}
            for path, leaf in want.items():
                if path not in arrays:
                    raise ValueError(f"Missing array '{path}' in checkpoint")
                a = np.asarray(arrays[path])  # lint: disable=DLT009 (restore time: checkpoint arrays onto the card once, never in a step)
                if tuple(a.shape) != tuple(leaf.shape):
                    raise ValueError(f"Shape mismatch for '{path}': checkpoint "
                                     f"{a.shape} vs model {tuple(leaf.shape)}")
                vals[path] = torch.from_numpy(np.array(a, dtype=np.float32)).to(leaf.device)  # lint: disable=DLT009 (restore time)
            model.compress_state = {
                "residual": (None if template["residual"] is None else
                             _rebuild(template["residual"], vals, "residual")),
                "ctrl": _rebuild(template["ctrl"], vals, "ctrl"),
                "acc": _rebuild(template["acc"], vals, "acc"),
            }
        except ValueError as e:
            log.warning("%s compression state does not fit the scheme's template "
                        "(%s): resetting the residuals to zeros", origin, e)
    watch = getattr(model, "_grad_compress_watch", None)
    if watch is not None:
        watch.reseed()
    return scheme


def ensure_compress_state(model):
    """``model.compress_state``, made (zeros) when compression is on and
    there is none yet."""
    scheme = getattr(model, "grad_compression", None)
    if scheme is None:
        return None
    if model.params is None:
        model.init()
    if getattr(model, "compress_state", None) is None:
        model.compress_state = scheme.init_state(model.params)
    return model.compress_state


def compression_stats(model) -> Optional[dict]:
    """The accumulators (and tau) as host floats; reads the device, so call
    it off the step path. None before the first state exists."""
    st = getattr(model, "compress_state", None)
    if st is None:
        return None
    out = {k: float(v) for k, v in st["acc"].items()}
    if "tau" in st["ctrl"]:
        out["tau"] = float(st["ctrl"]["tau"])
    return out


def measure_compression_overhead(model, repeats: int = 3) -> float:
    """Milliseconds of one ``apply`` over a zeros gradient tree of the
    model's shapes, best of ``repeats``: CUDA events on the card, the host
    clock on the CPU. Feeds the ``grad_compress_ms`` histogram and the
    ``grad_compress`` span. The model's state is not changed."""
    import time
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    from deeplearning4j_tpu_torch.obs.trace import get_tracer
    scheme = getattr(model, "grad_compression", None)
    if scheme is None:
        raise ValueError("model has no grad_compression scheme enabled")
    state = ensure_compress_state(model)
    grads = _rebuild(model.params, {p: torch.zeros(a.shape, dtype=torch.float32,
                                                   device=a.device)
                                    for p, a in _leaves(model.params)})
    cuda = model.device.type == "cuda"
    scheme.apply(grads, state)  # warm the allocator outside the clock
    hist = get_registry().histogram(
        "grad_compress_ms", unit="ms",
        help="time of one encode+decode+error-feedback pass over the full "
             "gradient tree (an isolated probe)")
    tracer = get_tracer()
    best = float("inf")
    for _ in range(max(1, int(repeats))):
        with tracer.span("grad_compress"):
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                scheme.apply(grads, state)
                end.record()
                end.synchronize()  # lint: disable=DLT009 (an isolated timing probe: the wait is the measurement)
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                scheme.apply(grads, state)
                ms = (time.perf_counter() - t0) * 1000.0
        hist.observe(ms)
        best = min(best, ms)
    return best
