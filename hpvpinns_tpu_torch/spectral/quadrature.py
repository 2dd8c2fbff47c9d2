"""Gauss–Jacobi and Gauss–Lobatto–Jacobi quadrature rules (numpy, host).

Counterpart of hpvpinns_tpu/spectral/quadrature.py: Golub–Welsch nodes on the
symmetric Jacobi tridiagonal matrix, in float64, computed once before
training.  The Lobatto interior nodes are the Gauss–Jacobi nodes of order
Q-2 with parameters (a+1, b+1).
"""

from __future__ import annotations

import math

import numpy as np

from hpvpinns_tpu_torch.spectral.jacobi import jacobi


def _jacobi_mu0(a: float, b: float) -> float:
    """mu0 = integral of the Jacobi weight (1-x)^a (1+x)^b over [-1, 1]."""
    return math.exp(
        (a + b + 1) * math.log(2.0)
        + math.lgamma(a + 1)
        + math.lgamma(b + 1)
        - math.lgamma(a + b + 2)
    )


def gauss_jacobi(Q: int, a: float, b: float):
    """Gauss–Jacobi rule: Q nodes/weights exact for degree <= 2Q-1.
    Returns (x, w) as float64 numpy arrays, nodes ascending."""
    if Q < 1:
        raise ValueError(f"Q must be >= 1, got {Q}")
    alpha = np.zeros(Q)
    beta = np.zeros(Q)
    alpha[0] = (b - a) / (a + b + 2.0)
    for n in range(1, Q):
        s = 2 * n + a + b
        alpha[n] = (b * b - a * a) / (s * (s + 2.0))
        beta[n] = (
            4.0 * n * (n + a) * (n + b) * (n + a + b)
            / (s * s * (s + 1.0) * (s - 1.0))
        )
    T = np.diag(alpha)
    if Q > 1:
        off = np.sqrt(beta[1:])
        T += np.diag(off, 1) + np.diag(off, -1)
    eigval, eigvec = np.linalg.eigh(T)
    w = _jacobi_mu0(a, b) * eigvec[0, :] ** 2
    return eigval, w


def gauss_lobatto_jacobi(Q: int, a: float, b: float):
    """Gauss–Lobatto–Jacobi rule with Q nodes including both endpoints ±1.
    Returns (x, w) as float64 numpy arrays, nodes ascending."""
    if Q < 2:
        raise ValueError(f"Lobatto rule needs Q >= 2, got {Q}")
    if Q == 2:
        interior = np.array([])
    else:
        interior, _ = gauss_jacobi(Q - 2, a + 1.0, b + 1.0)
    x = np.concatenate([[-1.0], interior, [1.0]])

    PQm1 = jacobi(Q - 1, a, b, x)
    if a == 0.0 and b == 0.0:
        w = 2.0 / (Q * (Q - 1) * PQm1**2)
    else:
        cg = math.exp(
            (a + b + 1) * math.log(2.0)
            + math.lgamma(a + Q)
            + math.lgamma(b + Q)
            - math.lgamma(Q)
            - math.lgamma(a + b + Q + 1)
        ) / (Q - 1)
        w = cg / PQm1**2
        w[0] *= b + 1.0
        w[-1] *= a + 1.0
    return x, w
