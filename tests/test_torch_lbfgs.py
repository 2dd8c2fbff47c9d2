"""Port parity, the L-BFGS optimizer (training/lbfgs.py) against the JAX
package's `optax.lbfgs()`, in float64 on the CPU.

The functions' values and gradients come from the same numpy code in both
packages (a pure callback under a custom VJP on the JAX side, a custom
autograd function on the port's), so what is compared is the optimizer
alone: the iterates after each of 30 iterations to 1e-10, and the number of
line-search trials of each iteration equal (ZoomLinesearchInfo's
num_linesearch_steps).  XLA's CPU backend rounds a multiply-add once, and
so does the port on the CPU; its dot products sum in another order, so the
iterates agree to rounding, not bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hpvpinns_tpu_torch.training import lbfgs  # noqa: E402

N_ITERS = 30


def rosenbrock(x):
    """(value, gradient) of sum 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2."""
    r, s = x[1:] - x[:-1] ** 2, 1 - x[:-1]
    g = np.zeros_like(x)
    g[:-1] += -400 * r * x[:-1] - 2 * s
    g[1:] += 200 * r
    return np.sum(100 * r * r + s * s), g


def make_quadratic(n=40, cond=1e3, seed=0):
    """(value, gradient) of 0.5 x'Ax - b'x, A symmetric positive definite
    with eigenvalues from 1 to `cond`."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
    b = rng.standard_normal(n)

    def f(x):
        Ax = A @ x
        return 0.5 * x @ Ax - b @ x, Ax - b

    return f


def wall(x):
    """(value, gradient) of -x + 1000 max(0, x - 1.2)^2: a descent that
    ends at a steep wall, so that trials overshoot and the search falls back
    on an earlier, safe step."""
    r = np.maximum(x - 1.2, 0.0)
    return np.sum(-x + 1000 * r * r), -1.0 + 2000 * r


def jax_fn(fnp, n):
    """fnp as a differentiable JAX function of an [n] array."""
    f64 = jax.ShapeDtypeStruct((), jnp.float64)

    @jax.custom_vjp
    def f(x):
        return jax.pure_callback(lambda x: np.float64(fnp(np.asarray(x))[0]), f64, x)

    def fwd(x):
        out = (f64, jax.ShapeDtypeStruct((n,), jnp.float64))
        return jax.pure_callback(lambda x: tuple(np.asarray(a, np.float64) for a in fnp(np.asarray(x))), out, x)

    f.defvjp(fwd, lambda g, ct: (ct * g,))
    return f


class _NumpyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fnp):
        value, grad = fnp(x.detach().numpy())
        ctx.grad = torch.as_tensor(np.asarray(grad))
        return torch.tensor(float(value), dtype=torch.float64)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.grad, None


def run_optax(fnp, x0, max_linesearch_steps=20):
    """optax.lbfgs() as the JAX trainer runs it: (iterates [N_ITERS, n],
    [(trials, decrease error, curvature error)] per iteration)."""
    f = jax_fn(fnp, x0.size)
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=max_linesearch_steps, initial_guess_strategy="one")
    opt = optax.lbfgs(linesearch=ls)
    value_and_grad = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(x, state):
        value, grad = value_and_grad(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad, value_fn=f)
        return optax.apply_updates(x, updates), state

    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    xs, infos = [], []
    for _ in range(N_ITERS):
        x, state = step(x, state)
        info = optax.tree.get(state, "info")
        xs.append(np.asarray(x))
        infos.append((int(info.num_linesearch_steps), float(info.decrease_error), float(info.curvature_error)))
    return np.array(xs), infos


def run_port(fnp, x0):
    p = torch.nn.Parameter(torch.tensor(x0, dtype=torch.float64))
    opt = lbfgs.LBFGS([p])

    def closure():
        opt.zero_grad()
        loss = _NumpyFn.apply(p, fnp)
        loss.backward()
        return loss

    xs, infos = [], []
    for _ in range(N_ITERS):
        opt.step(closure)
        xs.append(p.detach().numpy().copy())
        infos.append((opt.info.num_linesearch_steps, opt.info.decrease_error, opt.info.curvature_error))
    return np.array(xs), infos, opt


CASES = {
    "rosenbrock": (rosenbrock, np.array([-1.2, 1.0])),
    "quadratic": (make_quadratic(), np.random.default_rng(1).standard_normal(40)),
    "wall": (wall, np.array([0.0])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_iterates_and_trials_match_optax(case):
    fnp, x0 = CASES[case]
    want, jinfo = run_optax(fnp, x0)
    got, tinfo, opt = run_port(fnp, x0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert [i[0] for i in tinfo] == [i[0] for i in jinfo]
    assert opt.evaluations == 1 + sum(i[0] for i in jinfo)  # value_and_grad_from_state: one more, at the start
    assert fnp(got[-1])[0] < 1e-3 * fnp(x0)[0]


@pytest.mark.parametrize("case,max_steps", [("rosenbrock", 2), ("wall", 4)])
def test_failed_linesearch_takes_the_same_safe_step(case, max_steps, monkeypatch):
    """With few trials the search fails; each failure returns the step of the
    smallest value with sufficient decrease (with none, the last trial), as
    optax's _try_safe_step does.  On the wall the last trial overshoots
    (decrease error > 0) and the iterate is an earlier trial's."""
    fnp, x0 = CASES[case]
    want, jinfo = run_optax(fnp, x0, max_linesearch_steps=max_steps)
    monkeypatch.setattr(lbfgs, "MAX_LINESEARCH_STEPS", max_steps)
    got, tinfo, opt = run_port(fnp, x0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert [i[0] for i in tinfo] == [i[0] for i in jinfo]
    failed = [k for k, (_, dec, curv) in enumerate(jinfo) if max(dec, curv) > 0]
    assert failed and failed == [k for k, (_, dec, curv) in enumerate(tinfo) if max(dec, curv) > 0]
    assert opt.failed_searches == len(failed) and 0 < len(opt.unsafe_at) <= len(failed)
    assert set(opt.unsafe_at) <= set(failed) and all(tinfo[k][1] > 0 for k in opt.unsafe_at)
    np.testing.assert_allclose([tinfo[k][1:] for k in failed], [jinfo[k][1:] for k in failed], rtol=1e-8, atol=1e-12)
    if case == "wall":
        assert tinfo[0][1] > 0 and fnp(got[0])[0] < fnp(x0)[0]


def test_first_step_is_scaled_by_the_gradient_norm():
    """optax's first direction is -min(1, 1/||g||_2) g (torch's LBFGS scales by
    the 1-norm): on 0.5 ||x||^2 - b'x from 1.2 away from its minimum b, the
    first trial, of length 1, is accepted: x_1 = x_0 - g/||g||_2."""
    b = np.array([0.3, -1.0, 2.0, 0.5])

    def fnp(x):
        return 0.5 * x @ x - b @ x, x - b

    x0 = b + 1.2 * np.array([1.0, 2.0, -2.0, 4.0]) / 5.0
    g = fnp(x0)[1]
    got, tinfo, _ = run_port(fnp, x0)
    assert tinfo[0][0] == 1
    np.testing.assert_allclose(got[0], x0 - g / np.linalg.norm(g), rtol=1e-14)
