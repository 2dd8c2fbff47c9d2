"""Evaluation: dense-grid prediction, error metrics and the strong residual.

Counterpart of hpvpinns_tpu/evaluate.py (predict, rel_l2, evaluate,
strong_residual, per_element_rel_l2): the relative L2 error
||u - u_hat||_2 / ||u||_2 on the problem's test grid (and per component for
the systems, per element on a fresh grid), and the pointwise strong-form PDE
residual.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.ops.fields import (
    scalar_fields_1d, scalar_fields_2d, scalar_fields_3d, vector_fields_2d, vector_fields_3d,
)
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
    """Global rel-L2 and max/mean pointwise error on the test grid; a
    problem with several components (a trailing component axis on
    test_values, the Navier-Stokes (u, v, p)) also gets rel_l2_{name} for
    each, named by extras["component_names"]."""
    u_pred = predict(problem, params)
    u_true = np.asarray(problem.test_values)
    err = np.abs(u_true.reshape(-1) - u_pred.reshape(-1))
    out = {
        "rel_l2": rel_l2(u_pred, u_true),
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
    }
    if u_true.ndim == 2 and u_true.shape[1] > 1 and u_pred.shape == u_true.shape:
        names = problem.extras.get("component_names", tuple(f"c{i}" for i in range(u_true.shape[1])))
        for i, name in enumerate(names):
            out[f"rel_l2_{name}"] = rel_l2(u_pred[:, i], u_true[:, i])
    return out


def strong_residual(problem: Problem, params, X: Optional[np.ndarray] = None) -> np.ndarray:
    """Pointwise strong-form PDE residual at X [P, d] (default: the test
    grid), as numpy [P, 1]: the reference's `net_f` (Poisson-1D.py:150-155:
    -u_xx; Poisson-2D.py:187-194: u_xx + u_yy; Helmholtz-2D: u_xx + u_yy +
    k^2 u; AdvDiff.py:247-253: u_t + V u_x - eps u_xx; Burgers: u_t + u u_x
    - nu u_xx; AdvDiff-2D: u_t + vx u_x + vy u_y - eps (u_xx + u_yy); the
    Navier-Stokes systems: x-momentum, y-momentum and continuity, [P, 3],
    with nu the trainable leaf or the truth).  For
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
    elif problem.name in ("kovasznay", "taylorgreen"):
        nu = problem.extras["nu_of"](params)
        if problem.name == "kovasznay":
            flds = vector_fields_2d(u_fn, Xt[:, 0:1], Xt[:, 1:2])
            wt = torch.zeros_like(flds["w"])
        else:
            flds = vector_fields_3d(u_fn, Xt[:, 0:1], Xt[:, 1:2], Xt[:, 2:3])
            wt = flds["wz"]
        w, wx, wy, wxx, wyy = flds["w"], flds["wx"], flds["wy"], flds["wxx"], flds["wyy"]
        u, v = w[..., 0], w[..., 1]
        mom_x = wt[..., 0] + u * wx[..., 0] + v * wy[..., 0] + wx[..., 2] - nu * (wxx[..., 0] + wyy[..., 0])
        mom_y = wt[..., 1] + u * wx[..., 1] + v * wy[..., 1] + wy[..., 2] - nu * (wxx[..., 1] + wyy[..., 1])
        r = torch.cat([mom_x, mom_y, wx[..., 0] + wy[..., 1]], dim=-1)
    else:
        raise NotImplementedError(f"strong_residual for {problem.name!r} is not ported yet (ROADMAP.md)")
    return r.detach().cpu().numpy()


def per_element_rel_l2(problem: Problem, params, n_points: Optional[int] = None) -> np.ndarray:
    """Per-element rel-L2 on a fresh grid of n_points per axis in each
    element (defaults 500 / 40 / 16 in 1D / 2D / 3D): [E] in the mesh's flat
    element order (reshape with `problem.extras["mesh"].shape` for a map).
    A system's components enter each element's norm together."""
    mesh = problem.extras["mesh"]
    if not hasattr(mesh, "map_points"):
        raise TypeError("per_element_rel_l2 needs a mesh with map_points")
    dim = problem.test_points.shape[1]
    n = n_points or {1: 500, 2: 40, 3: 16}[dim]
    xi = np.linspace(-1.0, 1.0, n)
    if dim == 1:
        coords = (mesh.map_points(xi),)  # [E, P]
    elif dim in (2, 3):
        coords = mesh.map_points(*(xi,) * dim)  # each [E, P, P(, P)]
    else:
        raise ValueError(f"unsupported dimension {dim}")
    u_true = np.asarray(problem.exact(*coords))
    pts = np.stack([c.reshape(-1) for c in coords], axis=-1)
    shape = coords[0].shape
    u_pred = predict(problem, params, pts)
    if u_pred.size != int(np.prod(shape)):  # a trailing component axis (the systems)
        shape = shape + (u_pred.size // int(np.prod(shape)),)
    u_pred = u_pred.reshape(shape)
    u_true = u_true.reshape(shape)
    axes = tuple(range(1, u_true.ndim))
    num = np.sqrt(((u_true - u_pred) ** 2).sum(axis=axes))
    den = np.sqrt((u_true**2).sum(axis=axes))
    return num / den
