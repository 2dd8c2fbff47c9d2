"""Evaluation: dense-grid prediction and error metrics.

Counterpart of hpvpinns_tpu/evaluate.py (predict, rel_l2, evaluate): the
relative L2 error ||u - u_hat||_2 / ||u||_2 on the problem's test grid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
