"""Evaluation: dense-grid prediction, error metrics and the strong residual.

Counterpart of hpvpinns_tpu/evaluate.py (predict, rel_l2, evaluate,
strong_residual): the relative L2 error ||u - u_hat||_2 / ||u||_2 on the
problem's test grid, and the pointwise strong-form PDE residual.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.ops.fields import scalar_fields_1d, scalar_fields_2d, scalar_fields_3d
from hpvpinns_tpu_torch.problems.base import Problem


def predict(problem: Problem, params, X: Optional[np.ndarray] = None, batch_size: int = 262144) -> np.ndarray:
    """Network forward on X (default: the problem's dense test grid), in the
    problem's dtype on its device, returned as numpy."""
    if X is None:
        X = problem.test_points
    X = np.asarray(X)
    xb = problem.data["xb"]
    outs = []
    with torch.no_grad():
        for i in range(0, X.shape[0], batch_size):
            x = torch.as_tensor(X[i : i + batch_size]).to(device=xb.device, dtype=xb.dtype)
            outs.append(problem.apply(params, x).cpu().numpy())
    return np.concatenate(outs)


def rel_l2(u_pred: np.ndarray, u_true: np.ndarray) -> float:
    """Relative L2 error (Poisson-1D.py:192)."""
    u_pred = np.asarray(u_pred).reshape(-1)
    u_true = np.asarray(u_true).reshape(-1)
    return float(np.linalg.norm(u_true - u_pred) / np.linalg.norm(u_true))


def evaluate(problem: Problem, params) -> dict:
    """Global rel-L2 and max/mean pointwise error on the test grid."""
    u_pred = predict(problem, params)
    u_true = np.asarray(problem.test_values)
    err = np.abs(u_true.reshape(-1) - u_pred.reshape(-1))
    return {
        "rel_l2": rel_l2(u_pred, u_true),
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
    }


def strong_residual(problem: Problem, params, X: Optional[np.ndarray] = None) -> np.ndarray:
    """Pointwise strong-form PDE residual at X [P, d] (default: the test
    grid), as numpy [P, 1]: the reference's `net_f` (Poisson-1D.py:150-155:
    -u_xx; Poisson-2D.py:187-194: u_xx + u_yy; Helmholtz-2D: u_xx + u_yy +
    k^2 u; AdvDiff.py:247-253: u_t + V u_x - eps u_xx; Burgers: u_t + u u_x
    - nu u_xx; AdvDiff-2D: u_t + vx u_x + vy u_y - eps (u_xx + u_yy)).  For
    the Poisson problems it is f_pred - f(X); for Helmholtz-2D the operator
    value minus its forcing, with k^2 the trainable leaf or the truth; for
    AdvDiff the operator value minus the manufactured forcing, if any (F = 0
    in the reference); for Burgers the operator value; for AdvDiff-2D minus
    its manufactured forcing, with eps the trainable scalar, the true map
    epsilon_fn pointwise (forward runs) or eps_true.  Poisson-3D has no
    branch, as in the JAX package.  The JVP engine differentiates the full
    ansatz (problem.apply), so a hard-BC composite is differentiated
    correctly."""
    if X is None:
        X = problem.test_points
    X = np.asarray(X)
    xb = problem.data["xb"]
    Xt = torch.as_tensor(X).to(device=xb.device, dtype=xb.dtype)
    u_fn = lambda Z: problem.apply(params, Z)  # noqa: E731

    def on_device(a):
        return torch.as_tensor(np.asarray(a)).to(device=xb.device, dtype=xb.dtype)

    if problem.name == "poisson1d":
        _, _, uxx = scalar_fields_1d(u_fn, Xt[:, 0:1])
        r = -uxx - on_device(problem.extras["f_rhs"](X))
    elif problem.name == "poisson2d":
        flds = scalar_fields_2d(u_fn, Xt[:, 0:1], Xt[:, 1:2])
        r = flds["uxx"] + flds["uyy"] - on_device(problem.extras["f_rhs"](X[:, 0:1], X[:, 1:2]))
    elif problem.name == "helmholtz2d":
        k_sq = params["pde"]["k_sq"] if problem.config.inverse else problem.extras["k_sq_true"]
        flds = scalar_fields_2d(u_fn, Xt[:, 0:1], Xt[:, 1:2])
        r = flds["uxx"] + flds["uyy"] + k_sq * flds["u"] - on_device(problem.extras["f_rhs"](X[:, 0:1], X[:, 1:2]))
    elif problem.name == "burgers":
        flds = scalar_fields_2d(u_fn, Xt[:, 0:1], Xt[:, 1:2], first_y_only=True)
        r = flds["uy"] + flds["u"] * flds["ux"] - problem.config.nu * flds["uxx"]
    elif problem.name == "advdiff":
        eps = problem.extras["eps_of"](params, Xt[:, 0:1])
        V = problem.extras["v_of"](params, Xt[:, 0:1])
        flds = scalar_fields_2d(u_fn, Xt[:, 0:1], Xt[:, 1:2], first_y_only=True)
        r = flds["uy"] + V * flds["ux"] - eps * flds["uxx"]
        f_fn = problem.extras.get("f_rhs")
        if f_fn is not None:
            r = r - on_device(f_fn(X[:, 0:1], X[:, 1:2]))
    elif problem.name == "advdiff2d":
        eps_fn = problem.extras["epsilon_fn"]
        if problem.config.inverse:
            eps = params["pde"]["epsilon"]
        elif eps_fn is not None:
            eps = eps_fn(Xt[:, 0:1], Xt[:, 1:2])
        else:
            eps = problem.extras["eps_true"]
        vx, vy = problem.extras["v_of"](params)
        flds = scalar_fields_3d(u_fn, Xt[:, 0:1], Xt[:, 1:2], Xt[:, 2:3])
        r = flds["uz"] + vx * flds["ux"] + vy * flds["uy"] - eps * (flds["uxx"] + flds["uyy"])
        r = r - on_device(problem.extras["f_rhs"](X[:, 0:1], X[:, 1:2], X[:, 2:3]))
    else:
        raise NotImplementedError(f"strong_residual for {problem.name!r} is not ported yet (ROADMAP.md)")
    return r.detach().cpu().numpy()
