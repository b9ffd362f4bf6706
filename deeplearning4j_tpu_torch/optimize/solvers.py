"""Full-batch solvers: LBFGS, conjugate gradient, line gradient descent
(counterpart of ``deeplearning4j_tpu/optimize/solvers.py``; reference
``optimize/solvers/`` LBFGS.java, ConjugateGradient.java,
LineGradientDescent.java, BackTrackLineSearch.java, selected by
``optimization_algo`` and driven by Solver.java).

The solver works on the network's parameters flattened to one float32
vector on the network's device. The objective is the train-mode loss over
the whole batch, deterministic (no dropout draws, no augmentation); the
new batch-norm statistics it computes are discarded. Constraints are
projected after every step (the reference applies them after every
update).

- ``conjugate_gradient`` (Polak-Ribiere+, restarting along the steepest
  descent when the line search fails) and ``line_gradient_descent`` share
  :class:`BackTrackLineSearch`: Armijo backtracking from step 1 with
  contraction 0.5 and c1 = 1e-4, up to ``max_iterations`` trials.
- ``lbfgs`` follows optax 0.2.6's ``optax.lbfgs()``, which the JAX package
  runs: the two-loop recursion over the last ``memory`` (10) differences
  with a scaled identity as the initial preconditioner
  (``scale_init_precond=True``; the first step scaled by
  ``min(1, 1 / |g|)``), then ``scale_by_zoom_linesearch`` (at most 20
  steps, initial guess 1, sufficient decrease 1e-4 with the approximate
  decrease criterion at 1e-6, curvature 0.9, interval threshold 1e-5). The
  value and gradient the line search ends at are reused by the next
  iteration (optax's ``value_and_grad_from_state``), except after a
  projection, where they are recomputed. ``torch.optim.LBFGS`` has a
  strong-Wolfe search of its own that takes other steps, so it is not
  used. The line search runs its scalar logic on the host in float32, one
  device sync a trial; the JAX package runs it inside one compiled
  program, so the two agree within rounding, not bitwise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map

_ALGOS = ("lbfgs", "conjugate_gradient", "line_gradient_descent")
F = np.float32


class BackTrackLineSearch:
    """Armijo backtracking (reference BackTrackLineSearch.java:48:
    contraction rho = 0.5, sufficient decrease c1 = 1e-4, maxIterations)."""

    def __init__(self, max_iterations: int = 5, c1: float = 1e-4,
                 rho: float = 0.5, initial_step: float = 1.0):
        self.max_iterations = max_iterations
        self.c1 = c1
        self.rho = rho
        self.initial_step = initial_step

    def optimize(self, value_fn: Callable, w: torch.Tensor, f0, g0,
                 direction: torch.Tensor) -> float:
        """Step size along ``direction`` from ``w`` (0.0 when none gives a
        sufficient decrease, or ``direction`` does not descend)."""
        slope = float(torch.dot(g0.reshape(-1), direction.reshape(-1)))
        if slope >= 0:
            return 0.0
        alpha = self.initial_step
        f0 = float(f0)
        for _ in range(self.max_iterations):
            if float(value_fn(w + alpha * direction)) <= f0 + self.c1 * alpha * slope:
                return alpha
            alpha *= self.rho
        return 0.0


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none), as optax computes it."""
    with np.errstate(all="ignore"):
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1, r2 = fb - fa - C * db, fc - fa - C * dc
        A = (dc ** 2 * r1 - db ** 2 * r2) / denom
        B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
        radical = B * B - F(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (F(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / (db ** 2)
        return a - fpa / (F(2.0) * B)


def _nan_to_inf(x):
    return F(np.inf) if np.isnan(x) else x


def zoom_linesearch(value_and_grad, w, d, value, grad, max_steps: int = 20,
                    slope_rtol: float = 1e-4, curv_rtol: float = 0.9,
                    approx_dec_rtol: float = 1e-6, interval_threshold: float = 1e-5,
                    increase_factor: float = 2.0):
    """optax's ``zoom_linesearch`` (tol 0, no maximal step, initial guess
    1) along ``d`` from ``w``, where the value is ``value`` and the gradient
    ``grad``. Returns (stepsize, value, gradient) at the step taken."""
    slope_init = F(torch.dot(d, grad).item())
    value_init = F(value)
    slope_rtol, curv_rtol = F(slope_rtol), F(curv_rtol)
    approx_dec_rtol, increase_factor = F(approx_dec_rtol), F(increase_factor)

    def on_line(step):
        v, g = value_and_grad(torch.add(w, d, alpha=float(step)))
        return F(float(v)), g, F(torch.dot(g, d).item())

    def decrease_error(step, v, slope):
        # Armijo's sufficient decrease, or the approximate one of Hager and
        # Zhang near a minimum; NaN counts as violated
        with np.errstate(all="ignore"):
            err = v - value_init - slope_rtol * step * slope_init
            approx = np.maximum(slope - (F(2) * slope_rtol - F(1)) * slope_init,
                                v - value_init - approx_dec_rtol * abs(value_init))
            return _nan_to_inf(np.maximum(np.minimum(approx, err), F(0)))

    def curvature_error(slope):
        with np.errstate(all="ignore"):
            return _nan_to_inf(np.maximum(abs(slope) - curv_rtol * abs(slope_init), F(0)))

    st = dict(count=0, stepsize=F(0), value=value_init, grad=grad, slope=slope_init,
              decrease_error=F(np.inf), interval_found=False, done=False, failed=False,
              low=F(0), value_low=value_init, slope_low=slope_init,
              high=F(0), value_high=value_init, slope_high=slope_init,
              cubic_ref=F(0), value_cubic_ref=value_init,
              safe_stepsize=F(0), safe_value=value_init, safe_grad=grad)
    while not (st["done"] or st["failed"]):
        it = st["count"]
        if not st["interval_found"]:  # Algorithm 3.5 of Nocedal and Wright
            prev = (st["stepsize"], st["value"], st["slope"])
            new = F(1.0) if it == 0 else increase_factor * st["stepsize"]
            v, g, slope = on_line(new)
            dec, curv = decrease_error(new, v, slope), curvature_error(slope)
            err = max(dec, curv)
            if dec <= 0:
                st.update(safe_stepsize=new, safe_value=v, safe_grad=g)
            set_high = dec > 0 or (v >= prev[1] and it > 0)
            set_low = slope >= 0 and not set_high
            if set_low:
                lo, hi = (new, v, slope), prev
            else:
                lo, hi = prev, (new, v, slope)
            st.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                      high=hi[0], value_high=hi[1], slope_high=hi[2],
                      cubic_ref=lo[0], value_cubic_ref=lo[1],
                      interval_found=set_high or set_low or err <= 0)
            done = err <= 0
            failed = it + 1 >= max_steps and not done
        else:  # the zoom, Algorithm 3.6
            low, vlow, slow = st["low"], st["value_low"], st["slope_low"]
            high, vhigh, shigh = st["high"], st["value_high"], st["slope_high"]
            with np.errstate(all="ignore"):
                delta = abs(high - low)
                left, right = min(high, low), max(high, low)
                cubic = _cubicmin(low, vlow, slow, high, vhigh, st["cubic_ref"],
                                  st["value_cubic_ref"])
                quad = _quadmin(low, vlow, slow, high, vhigh)
                use_cubic = bool(left + F(0.2) * delta < cubic < right - F(0.2) * delta)
                use_quad = (not use_cubic) and bool(left + F(0.1) * delta < quad
                                                     < right - F(0.1) * delta)
                new = cubic if use_cubic else quad if use_quad else (low + high) / F(2.0)
            v, g, slope = on_line(new)
            dec, curv = decrease_error(new, v, slope), curvature_error(slope)
            done = max(dec, curv) <= 0
            if dec <= 0 and v < st["safe_value"]:
                st.update(safe_stepsize=new, safe_value=v, safe_grad=g)
            set_high_mid = dec > 0 or v >= vlow
            set_high_low = slope * (high - low) >= 0 and not set_high_mid
            hi = (new, v, slope) if set_high_mid else (high, vhigh, shigh)
            if set_high_low:
                hi = (low, vlow, slow)
            lo = (low, vlow, slow) if set_high_mid else (new, v, slope)
            ref = (high, vhigh) if (set_high_mid or set_high_low) else (low, vlow)
            st.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                      high=hi[0], value_high=hi[1], slope_high=hi[2],
                      cubic_ref=ref[0], value_cubic_ref=ref[1])
            failed = ((it + 1 >= max_steps or (delta <= interval_threshold
                                               and st["safe_stepsize"] > 0))
                      and not done)
        st.update(count=it + 1, stepsize=new, value=v, grad=g, slope=slope,
                  decrease_error=dec, done=done, failed=failed)
        if failed and (st["safe_stepsize"] > 0 or np.isinf(dec)):
            # optax's _try_safe_step: the best step with sufficient decrease
            st.update(stepsize=st["safe_stepsize"], value=st["safe_value"],
                      grad=st["safe_grad"])
    return float(st["stepsize"]), st["value"], st["grad"]


class Solver:
    """Full-batch optimizer over a network's parameters (reference
    Solver.java + BaseOptimizer.java): ``optimize(net, dataset)`` runs up
    to ``max_iterations`` steps of the chosen algorithm (fewer when the
    score moves by less than ``tol``) and writes the parameters back into
    the network. ``score_history`` holds the score at the start of each
    iteration."""

    def __init__(self, algo: str = "lbfgs", max_iterations: int = 100,
                 memory: int = 10, tol: float = 1e-8,
                 line_search: Optional[BackTrackLineSearch] = None):
        if algo not in _ALGOS:
            raise ValueError(f"Unknown solver algo {algo!r}; one of {_ALGOS}")
        self.algo = algo
        self.max_iterations = max_iterations
        self.memory = memory
        self.tol = tol
        self.line_search = line_search or BackTrackLineSearch()
        self.score_history: list = []

    # ------------------------------------------------------------ plumbing
    @staticmethod
    def _flat_fns(net, ds):
        """(w0, unravel, value_fn, value_and_grad): the parameters as one
        vector, its views back in the network's tree, and the full-batch
        loss (and gradient) as functions of the vector."""
        x, y, fm, lm = net._batch(ds)
        leaves = tree_leaves(net.params)
        sizes = [t.numel() for t in leaves]
        w0 = torch.cat([t.detach().reshape(-1).float() for t in leaves])

        def unravel(w):
            parts = iter(torch.split(w, sizes))
            return tree_map(lambda t: next(parts).view(t.shape), net.params)

        def loss(w):
            return net._loss_fn(unravel(w), net.state, x, y, None, fm, lm)[0]

        def value_fn(w):
            with torch.no_grad():
                return loss(w).float()

        def value_and_grad(w):
            w = w.detach().requires_grad_(True)
            v = loss(w)
            (g,) = torch.autograd.grad(v, w)
            return v.detach().float(), g

        return w0, unravel, value_fn, value_and_grad

    @staticmethod
    def _make_projection(net, unravel):
        """The layers' constraints applied to a copy of the vector, or None
        when no layer has any."""
        from deeplearning4j_tpu_torch.nn.conf.layers import apply_constraints, reg_object
        layers = getattr(net, "layers", None)
        if not layers or not any(reg_object(layer, "constraints") for layer in layers):
            return None

        def project(w):
            w = w.detach().clone()
            for layer, p in zip(layers, unravel(w)):
                apply_constraints(layer, p)
            return w

        return project

    # ----------------------------------------------------------- algorithms
    def optimize(self, net, ds) -> float:
        """Run the solver; returns the final score and updates the
        network's parameters in place."""
        if net.params is None:
            net.init()
        w, unravel, value_fn, value_and_grad = self._flat_fns(net, ds)
        project = self._make_projection(net, unravel)
        if self.algo == "lbfgs":
            w = self._run_lbfgs(w, value_and_grad, project)
        else:
            w = self._run_cg(w, value_fn, value_and_grad, project,
                             use_conjugacy=self.algo == "conjugate_gradient")
        with torch.no_grad():
            tree_map(lambda p, v: p.copy_(v), net.params, unravel(w))
        final = float(value_fn(w))
        net._score = final
        return final

    def _run_lbfgs(self, w, value_and_grad, project=None):
        m, n = self.memory, w.numel()
        dw_mem = torch.zeros((m, n), dtype=w.dtype, device=w.device)
        du_mem = torch.zeros_like(dw_mem)
        rhos = torch.zeros(m, dtype=w.dtype, device=w.device)
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        prev_w = prev_g = None
        ls_value, ls_grad = math.inf, None
        if project is not None:
            w = project(w)
        prev = np.inf
        for count in range(self.max_iterations):
            if project is None and np.isfinite(ls_value):
                value, grad = ls_value, ls_grad
            else:
                value, grad = value_and_grad(w)
                value = float(value)
            # scale_by_lbfgs: the memory first, then the direction
            idx, prev_idx = count % m, (count - 1) % m
            if count > 0:
                dw, du = w - prev_w, grad - prev_g
                vd = torch.dot(du, dw)
                dw_mem[prev_idx] = dw
                du_mem[prev_idx] = du
                rhos[prev_idx] = torch.where(vd == 0, zero, 1.0 / vd)
                den = torch.dot(du, du)
                scale = torch.where(den > 0, vd / den, torch.ones_like(den))
            else:
                dw_mem[prev_idx] = 0
                du_mem[prev_idx] = 0
                rhos[prev_idx] = 0
                scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad), 1.0)
            order = [(idx + j) % m for j in range(m)]
            vec, alphas = grad, {}
            for j in reversed(order):
                alphas[j] = rhos[j] * torch.dot(dw_mem[j], vec)
                vec = vec + (-alphas[j]) * du_mem[j]
            vec = scale * vec
            for j in order:
                beta = rhos[j] * torch.dot(du_mem[j], vec)
                vec = vec + (alphas[j] - beta) * dw_mem[j]
            prev_w, prev_g = w, grad
            d = -vec
            step, ls_value, ls_grad = zoom_linesearch(value_and_grad, w, d, value, grad)
            ls_value = float(ls_value)
            w = torch.add(w, d, alpha=step)
            if project is not None:
                w = project(w)
            self.score_history.append(value)
            if abs(prev - value) < self.tol:
                break
            prev = value
        return w

    def _run_cg(self, w, value_fn, value_and_grad, project=None, use_conjugacy: bool = True):
        """Polak-Ribiere+ nonlinear CG (reference ConjugateGradient.java);
        with ``use_conjugacy=False`` it is LineGradientDescent (steepest
        descent and the line search)."""
        g = value_and_grad(w)[1]
        d = -g
        prev_v = np.inf
        for _ in range(self.max_iterations):
            f0 = value_fn(w)
            v = float(f0)
            self.score_history.append(v)
            alpha = self.line_search.optimize(value_fn, w, f0, g, d)
            if alpha == 0.0:
                # line search failed: restart along the steepest descent
                d = -g
                alpha = self.line_search.optimize(value_fn, w, f0, g, d)
                if alpha == 0.0:
                    break
            w = w + alpha * d
            if project is not None:
                w = project(w)
            g_new = value_and_grad(w)[1]
            if use_conjugacy:
                beta = float(torch.dot(g_new, g_new - g)
                             / torch.clamp_min(torch.dot(g, g), 1e-30))
                beta = max(beta, 0.0)  # PR+ restart
            else:
                beta = 0.0
            d = -g_new + beta * d
            g = g_new
            if abs(prev_v - v) < self.tol:
                break
            prev_v = v
        return w
