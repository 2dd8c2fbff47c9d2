"""L-BFGS with a zoom line search: the JAX package's `optax.lbfgs()`.

Counterpart of the second training phase of hpvpinns_tpu/training/trainer.py
(optax.lbfgs() with its defaults, optax 0.2.6):

- the direction (optax/_src/transform.py, scale_by_lbfgs and
  _precondition_by_lbfgs): the two-loop recursion over the last 10 pairs
  (s, y) = (x_k - x_{k-1}, g_k - g_{k-1}), weights 1/<y, s> (0 where <y, s>
  is 0), the initial inverse Hessian gamma I with gamma = <y, s>/<y, y> from
  the newest pair, and gamma = min(1, 1/||g||_2) at the first iteration;
  the update is d = -P g;
- the stepsize (optax/_src/linesearch.py, zoom_linesearch with
  scale_by_zoom_linesearch's defaults and optax.lbfgs's arguments): at most
  20 trials from the guess 1, Armijo with slope_rtol 1e-4 or Hager-Zhang's
  approximate decrease within approx_dec_rtol 1e-6 of |f_0|, curvature
  |slope| <= 0.9 |slope_0|, an interval search that doubles the step, a zoom
  by cubic, quadratic or bisection steps with their safeguards, and on
  failure the safe step (the best one of sufficient decrease);
- value and gradient at the accepted trial are the next iteration's
  (optax.value_and_grad_from_state): an iteration evaluates the closure
  once per trial, and once more only at the very first iteration or after a
  step that left a value that is not finite.

The vectors live on the parameters' device, flattened in the order of
`params` (problems/base.py::parameters); the line search's branches run on
the host in float64, one sync per trial (its value and its slope <g, d>, and
at the first trial of an iteration the initial slope too).  A trial writes
x_0 + t d into the same parameter tensors (copy_, never a rebind), so a
closure that replays a CUDA graph keeps working.  On the card the direction,
after the first iteration, is a captured CUDA graph of its ~150 small
launches (`capture_direction` False keeps it eager, to hold the two
against each other).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

_f = np.float64
# optax.lbfgs()'s settings (memory_size; scale_by_zoom_linesearch's defaults)
MEMORY_SIZE = 10
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, STEPSIZE_PRECISION = 2.0, 1e-5
MAX_LINESEARCH_STEPS = 20  # optax.lbfgs()'s; read at each step, so a test may patch it


@dataclass
class LinesearchInfo:
    """The last iteration's line search (optax.ZoomLinesearchInfo)."""

    num_linesearch_steps: int
    decrease_error: float
    curvature_error: float


def _fma(a, b, c):
    """a * b + c; a is a number or a 0-d tensor, b a tensor like c.

    On the card a plain multiply-add.  On the CPU it is rounded once, by
    Dekker's exact product (Veltkamp splits) and an exact sum: XLA's CPU
    backend contracts optax's multiply-adds so, and this path exists only
    so that the CPU parity tests (tests/test_torch_lbfgs.py,
    tests/test_torch_trainer.py) can hold the port to optax at 1e-10."""
    if c.is_cuda:
        return torch.add(c, b, alpha=a) if isinstance(a, float) else torch.addcmul(c, a, b)
    k = 134217729.0 if c.dtype == torch.float64 else 4097.0

    def split(x):
        t = k * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # p's rounding error, exactly
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)  # s's rounding error, exactly
    return s + (t + e)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with slope
    fpa at a (linesearch.py::_cubicmin); NaN when it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * (dc * dc)) * r0 + db * (db * db) * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope fpa
    at a (linesearch.py::_quadmin)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class LBFGS(torch.optim.Optimizer):
    """optax.lbfgs() as a torch optimizer: `step(closure)` is one iteration.

    The closure evaluates the loss at the current parameters, sets their
    `.grad` (None counts as zero) and returns the loss.  `evaluations`
    counts closure calls, `failed_searches` the line searches that failed,
    and `unsafe_at` the iterations (0 the first) whose search failed with no
    trial of sufficient decrease and took its last trial, as optax does: the
    only steps after which the loss may rise by more than approx_dec_rtol
    |f_0|.  `info` is the last line search."""

    def __init__(self, params: Iterable[torch.Tensor]):
        super().__init__(list(params), {})
        self.count = 0  # iterations done (optax's ScaleByLBFGSState.count)
        self.evaluations = 0
        self.failed_searches = 0  # searches that ended without both conditions
        self.unsafe_at: List[int] = []
        self.capture_direction = True
        self.info: Optional[LinesearchInfo] = None
        self._value = np.inf  # loss at the current params, from the accepted trial
        self._grad: Optional[torch.Tensor] = None  # its gradient, flat
        self._buffers = None
        self._graph = None

    @property
    def value(self) -> float:
        """The loss at the current params (the accepted trial's)."""
        return self._value

    @property
    def _params(self):
        return self.param_groups[0]["params"]

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in self._params])

    def _init_buffers(self):
        ps = self._params
        x = torch.cat([p.detach().reshape(-1) for p in ps])
        n, m = x.numel(), MEMORY_SIZE
        z = lambda *shape: torch.zeros(shape, dtype=x.dtype, device=x.device)  # noqa: E731
        self._buffers = dict(x=x, x0=z(n), g=z(n), x_prev=z(n), g_prev=z(n), d=z(n), slope0=z(),
                             S=z(m, n), Y=z(m, n), rho=z(m))
        self._views = [v.view_as(p) for v, p in zip(x.split([p.numel() for p in ps]), ps)]

    def _write(self, t: float):
        """params = x_0 + t d, into the same tensors (optax: params + t u)."""
        b = self._buffers
        b["x"].copy_(_fma(float(t), b["d"], b["x0"]))
        torch._foreach_copy_([p.detach() for p in self._params], self._views)

    def _direction(self, first: bool):
        """d = -P g (scale_by_lbfgs then scale(-1)) and the initial slope
        <d, g>, from the current x and g; updates the pair memory.  Device
        operations into persistent buffers only (capturable)."""
        b = self._buffers
        x, g, S, Y, rho = b["x"], b["g"], b["S"], b["Y"], b["rho"]
        m = MEMORY_SIZE
        if first:
            gamma = torch.clamp(1.0 / torch.sqrt(torch.sum(g * g)), max=1.0)
        else:
            s, y = x - b["x_prev"], g - b["g_prev"]
            sy = torch.sum(y * s)
            w = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            for buf, new in ((S, s), (Y, y), (rho, w)):
                buf.copy_(torch.roll(buf, -1, 0))
                buf[m - 1].copy_(new)
            yy = torch.sum(y * y)
            gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(yy))
        q = g
        alphas = []
        for i in range(m - 1, -1, -1):  # newest pair first
            a = rho[i] * torch.sum(S[i] * q)
            q = _fma(-a, Y[i], q)
            alphas.append(a)
        q = gamma * q
        for i in range(m):  # oldest pair first
            beta = rho[i] * torch.sum(Y[i] * q)
            q = _fma(alphas[m - 1 - i] - beta, S[i], q)
        b["d"].copy_(-1.0 * q)
        b["x_prev"].copy_(x)
        b["g_prev"].copy_(g)
        b["slope0"].copy_(torch.sum(b["d"] * g))

    def _run_direction(self):
        first = self.count == 0
        on_card = self._buffers["x"].is_cuda
        if self._graph is not None:
            self._graph.replay()
            return
        self._direction(first)
        if on_card and not first and self.capture_direction:  # the eager call warmed the same launches up
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._direction(False)
            self._graph = graph

    def _evaluate(self, closure: Callable):
        """(loss tensor, flat gradient) at the current params."""
        with torch.enable_grad():
            loss = closure()
        self.evaluations += 1
        return loss.detach(), self._flat_grad()

    @torch.no_grad()
    def step(self, closure: Callable):  # noqa: C901 - one branch per optax case
        if self._buffers is None:
            self._init_buffers()
        b = self._buffers
        if not np.isfinite(self._value):  # optax.value_and_grad_from_state
            loss, self._grad = self._evaluate(closure)
            self._value = float(loss)
        b["g"].copy_(self._grad)
        self._run_direction()
        b["x0"].copy_(b["x"])
        dtype = b["x"].dtype

        f0, s0 = _f(self._value), None
        max_steps, tol = MAX_LINESEARCH_STEPS, _f(0.0)

        def trial(t):
            nonlocal s0
            self._write(t)
            loss, grad = self._evaluate(closure)
            out = [loss.to(dtype), torch.sum(grad * b["d"])] + ([b["slope0"]] if s0 is None else [])
            vals = torch.stack(out).tolist()  # the one host sync of a trial
            if s0 is None:
                s0 = _f(vals[2])
            return _f(vals[0]), _f(vals[1]), grad

        def decrease_error(t, v, sl):
            """Armijo, or Hager-Zhang's approximate decrease near f0."""
            err = v - f0 - SLOPE_RTOL * t * s0
            approx_err = np.maximum(sl - (2 * SLOPE_RTOL - 1.0) * s0, v - f0 - APPROX_DEC_RTOL * np.abs(f0))
            err = np.maximum(np.minimum(approx_err, err), 0.0)
            return _f(np.inf) if np.isnan(err) else err

        def curvature_error(sl):
            err = np.maximum(np.abs(sl) - CURV_RTOL * np.abs(s0), 0.0)
            return _f(np.inf) if np.isnan(err) else err

        with np.errstate(all="ignore"):
            count, interval_found, done, failed = 0, False, False, False
            stepsize, value, grad, slope = _f(0.0), f0, self._grad, None
            dec_err = curv_err = _f(np.inf)
            low = high = cubic_ref = _f(0.0)
            value_low = value_high = value_cubic_ref = f0
            slope_low = slope_high = None
            safe_stepsize, safe_value, safe_grad = _f(0.0), f0, self._grad
            last_t = None
            while not (done or failed):
                if not interval_found:  # _search_interval
                    new_t = _f(1.0) if count == 0 else INCREASE_FACTOR * stepsize
                    v, sl, gr = trial(new_t)
                    last_t = new_t
                    if count == 0:  # the initial state's slopes (init_fn)
                        slope, slope_low, slope_high = s0, s0, s0
                    dec_err, curv_err = decrease_error(new_t, v, sl), curvature_error(sl)
                    err = np.maximum(dec_err, curv_err)
                    if dec_err <= tol:
                        safe_stepsize, safe_value, safe_grad = new_t, v, gr
                    set_high = (dec_err > 0.0) or (v >= value and count > 0)
                    set_low = (sl >= 0.0) and not set_high
                    if set_low:
                        low, value_low, slope_low, high, value_high, slope_high = new_t, v, sl, stepsize, value, slope
                    else:
                        low, value_low, slope_low, high, value_high, slope_high = stepsize, value, slope, new_t, v, sl
                    interval_found = set_high or set_low or err <= tol
                    done = bool(err <= tol)
                    failed = (count + 1 >= max_steps) and not done
                    cubic_ref, value_cubic_ref = low, value_low
                    stepsize, value, grad, slope = new_t, v, gr, sl
                else:  # _zoom_into_interval
                    delta = np.abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
                    too_small = delta <= STEPSIZE_PRECISION
                    mid_cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref, value_cubic_ref)
                    use_cubic = bool((mid_cubic > left + cubic_chk) & (mid_cubic < right - cubic_chk))
                    mid_quad = _quadmin(low, value_low, slope_low, high, value_high)
                    use_quad = (not use_cubic) and bool((mid_quad > left + quad_chk) & (mid_quad < right - quad_chk))
                    if use_cubic:
                        middle = mid_cubic
                    elif use_quad:
                        middle = mid_quad
                    else:
                        middle = (low + high) / 2.0
                    v, sl, gr = trial(middle)
                    last_t = middle
                    dec_err, curv_err = decrease_error(middle, v, sl), curvature_error(sl)
                    err = np.maximum(dec_err, curv_err)
                    if dec_err <= tol and v < safe_value:
                        safe_stepsize, safe_value, safe_grad = middle, v, gr
                    done = bool(err <= tol)
                    set_high_to_middle = (dec_err > 0.0) or (v >= value_low)
                    set_high_to_low = (sl * (high - low) >= 0.0) and not set_high_to_middle
                    old_high, old_value_high = high, value_high
                    if set_high_to_middle:
                        high, value_high, slope_high = middle, v, sl
                    if set_high_to_low:
                        high, value_high, slope_high = low, value_low, slope_low
                    if set_high_to_middle or set_high_to_low:
                        cubic_ref, value_cubic_ref = old_high, old_value_high
                    else:
                        cubic_ref, value_cubic_ref = low, value_low
                    if not set_high_to_middle:
                        low, value_low, slope_low = middle, v, sl
                    presumably_failed = (count + 1 >= max_steps) or (too_small and safe_stepsize > 0.0)
                    failed = presumably_failed and not done
                    stepsize, value, grad, slope = middle, v, gr, sl
                count += 1
                if failed and (safe_stepsize > 0.0 or np.isinf(dec_err)):  # _try_safe_step
                    stepsize, value, grad = safe_stepsize, safe_value, safe_grad
                elif failed:  # no trial decreased enough: optax takes the last, whatever its value
                    self.unsafe_at.append(self.count)
            self.failed_searches += int(failed)

        if stepsize != last_t:
            self._write(float(stepsize))
        self._value, self._grad = float(value), grad
        self.info = LinesearchInfo(count, float(dec_err), float(curv_err))
        self.count += 1
        return self._value
