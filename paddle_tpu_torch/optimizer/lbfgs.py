"""L-BFGS (counterpart of paddle_tpu/optimizer/lbfgs.py:28): the
closure-based step, the two-loop recursion over an (s, y) history of at
most `history_size` pairs, and an optional strong-Wolfe line search
(bracketing, then bisection zoom).

The model evaluations run wherever the closure runs them (the card for
the port's models); the history and the directions are flat f32
vectors on the parameters' device. Like the reference, the step reads
values back to the host at its tests, and only there: each
evaluation's loss, the directional derivatives, the curvature y·s and
y·y, and the largest |gradient| and |step| against the tolerances.
Parameters are torch tensors or the eager API's Parameters / Tensors
(stepped through their torch tensors, in place); those whose
``requires_grad`` is off are left out, as the reference leaves out
``stop_gradient`` ones."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.tensor import Tensor
from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _gather_flat(tensors):
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _dot(a, b):
    return float(torch.dot(a, b))


def _coerce_decay(weight_decay):
    """The decay as a float coefficient of coupled L2 (g += wd * p): a
    float, or a regularizer's ``_coeff``; an L1 regularizer raises
    TypeError rather than being read as L2 (lbfgs.py:33-51)."""
    if weight_decay is None:
        return None
    if hasattr(weight_decay, "_coeff"):
        if "L1" in type(weight_decay).__name__:
            raise TypeError(
                f"LBFGS weight_decay got {type(weight_decay).__name__}; "
                "only L2-style decay (a float coefficient) is supported")
        return float(weight_decay._coeff)
    try:
        return float(weight_decay)
    except (TypeError, ValueError):
        raise TypeError(
            "LBFGS weight_decay must be a float or a regularizer with a "
            f"coefficient, got {type(weight_decay).__name__}") from None


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=_coerce_decay(weight_decay),
                         grad_clip=grad_clip, name=name)
        self.max_iter = max_iter
        self.max_eval = max_iter * 5 // 4 if max_eval is None else max_eval
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                "line_search_fn must be None or 'strong_wolfe'")
        self.line_search_fn = line_search_fn
        self._s_hist: list = []
        self._y_hist: list = []
        self._rho: list = []
        self._prev_flat_grad = None
        self._H_diag = 1.0
        self._n_evals = 0

    # -- flat parameter plumbing --
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _flat_params(self):
        return _gather_flat([p.detach() for p in self._params()])

    def _flat_grad(self):
        grads = []
        for p in self._params():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.weight_decay:
                g = g + float(self.weight_decay) * p.detach()
            grads.append(g)
        return _gather_flat(grads)

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _direction(self, flat_grad):
        """The two-loop recursion over the (s, y) history."""
        q = -flat_grad
        m = len(self._s_hist)
        alphas = [None] * m
        for i in range(m - 1, -1, -1):
            alphas[i] = self._rho[i] * torch.dot(self._s_hist[i], q)
            q = q - alphas[i] * self._y_hist[i]
        d = q * self._H_diag
        for i in range(m):
            beta = self._rho[i] * torch.dot(self._y_hist[i], d)
            d = d + self._s_hist[i] * (alphas[i] - beta)
        return d

    def _eval(self, closure, flat_x):
        self._set_flat_params(flat_x)
        with torch.enable_grad():
            loss = closure()
        self._n_evals += 1
        return float(loss), self._flat_grad()

    def _strong_wolfe(self, closure, x, d, f0, g0, t, c1=1e-4, c2=0.9,
                      max_ls=25):
        """Bracketing strong-Wolfe line search; (f_new, g_new, t)."""
        gtd0 = _dot(g0, d)
        f_prev, t_prev = f0, 0.0
        g_new, f_new = g0, f0
        for ls in range(max_ls):
            f_new, g_new = self._eval(closure, x + t * d)
            gtd = _dot(g_new, d)
            if f_new > f0 + c1 * t * gtd0 or (ls > 0 and f_new >= f_prev):
                return self._zoom(closure, x, d, f0, gtd0, t_prev, f_prev,
                                  t, f_new, c1, c2)
            if abs(gtd) <= -c2 * gtd0:
                return f_new, g_new, t
            if gtd >= 0:
                return self._zoom(closure, x, d, f0, gtd0, t, f_new, t_prev,
                                  f_prev, c1, c2)
            f_prev, t_prev = f_new, t
            t = t * 2.0
        return f_new, g_new, t

    def _zoom(self, closure, x, d, f0, gtd0, t_lo, f_lo, t_hi, f_hi, c1, c2,
              max_zoom=25):
        f_new, g_new, t = f_lo, None, t_lo
        for _ in range(max_zoom):
            t = 0.5 * (t_lo + t_hi)
            f_new, g_new = self._eval(closure, x + t * d)
            gtd = _dot(g_new, d)
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                t_hi, f_hi = t, f_new
            else:
                if abs(gtd) <= -c2 * gtd0:
                    break
                if gtd * (t_hi - t_lo) >= 0:
                    t_hi, f_hi = t_lo, f_lo
                t_lo, f_lo = t, f_new
            if abs(t_hi - t_lo) < 1e-12:
                break
        if g_new is None:
            f_new, g_new = self._eval(closure, x + t * d)
        return f_new, g_new, t

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        """Up to `max_iter` L-BFGS iterations from the closure's loss and
        gradients (`closure` clears the grads, computes the loss, calls
        backward and returns it), stopping at `max_eval` evaluations or
        at the tolerances. Returns the last loss as a 0-d Tensor (the
        closure's own loss when the first gradient is already within
        tolerance_grad)."""
        if closure is None:
            raise ValueError(
                "LBFGS.step requires a closure that re-evaluates the "
                "model and returns the loss")
        lr = self.get_lr()
        self._n_evals = 0
        with torch.enable_grad():
            loss = closure()
        self._n_evals += 1
        f = float(loss)
        flat_grad = self._flat_grad()
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return loss
        for _ in range(self.max_iter):
            if self._prev_flat_grad is not None:
                y = flat_grad - self._prev_flat_grad
                s = self._last_step
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(self._s_hist) >= self.history_size:
                        self._s_hist.pop(0)
                        self._y_hist.pop(0)
                        self._rho.pop(0)
                    self._s_hist.append(s)
                    self._y_hist.append(y)
                    self._rho.append(1.0 / ys)
                    self._H_diag = ys / _dot(y, y)
            d = self._direction(flat_grad)
            if _dot(flat_grad, d) > -self.tolerance_change:
                break
            t = lr if self._s_hist else \
                min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr
            x = self._flat_params()
            self._prev_flat_grad = flat_grad
            if self.line_search_fn == "strong_wolfe":
                f_new, g_new, t = self._strong_wolfe(closure, x, d, f,
                                                     flat_grad, t)
                self._set_flat_params(x + t * d)
            else:
                f_new, g_new = self._eval(closure, x + t * d)
            self._last_step = t * d
            done = self._n_evals >= self.max_eval or \
                abs(f_new - f) < self.tolerance_change or \
                float((t * d).abs().max()) < self.tolerance_change
            f, flat_grad = f_new, g_new
            if done or float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
        self._step_count += 1
        return Tensor._wrap(torch.tensor(f, dtype=torch.float32),
                            stop_gradient=True)
