"""Petrov–Galerkin test-function basis tensors (numpy, host).

Counterpart of hpvpinns_tpu/spectral/basis.py.  Test functions are the
Legendre differences phi_n = P_{n+1} - P_{n-1}, n = 1..N, which vanish at
x = ±1; derivatives use the Jacobi shift identities

    phi_n'  = ((n+2)/2) P_n^{(1,1)}        - (n/2)        P_{n-2}^{(1,1)}
    phi_n'' = ((n+2)(n+3)/4) P_{n-1}^{(2,2)} - (n(n+1)/4) P_{n-3}^{(2,2)}

with P_m = 0 for m < 0.  Evaluated once in float64 and shipped to the device
as constant [N, Q] tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hpvpinns_tpu_torch.spectral.jacobi import jacobi_all


@dataclass(frozen=True)
class TestBasis:
    """phi, dphi, d2phi: [N, Q] at the sample points; *_b: [N, 2] at ±1."""

    n_test: int
    xi: np.ndarray
    phi: np.ndarray
    dphi: np.ndarray
    d2phi: np.ndarray
    phi_b: np.ndarray
    dphi_b: np.ndarray
    d2phi_b: np.ndarray


def _eval_basis(n_test: int, x: np.ndarray):
    x = np.asarray(x, dtype=np.float64)
    P = jacobi_all(n_test + 1, 0.0, 0.0, x)
    P11 = jacobi_all(n_test, 1.0, 1.0, x)
    P22 = jacobi_all(max(n_test - 1, 0), 2.0, 2.0, x)

    phi = np.empty((n_test,) + x.shape)
    dphi = np.empty_like(phi)
    d2phi = np.empty_like(phi)
    for n in range(1, n_test + 1):
        phi[n - 1] = P[n + 1] - P[n - 1]
        d1 = (n + 2) / 2.0 * P11[n]
        if n - 2 >= 0:
            d1 = d1 - n / 2.0 * P11[n - 2]
        dphi[n - 1] = d1
        d2 = (n + 2) * (n + 3) / 4.0 * P22[n - 1]
        if n - 3 >= 0:
            d2 = d2 - n * (n + 1) / 4.0 * P22[n - 3]
        d2phi[n - 1] = d2
    return phi, dphi, d2phi


def make_test_basis(n_test: int, xi: np.ndarray) -> TestBasis:
    """[N, Q] basis tensors at sample points `xi` plus the [N, 2] endpoint
    tensors."""
    xi = np.asarray(xi, dtype=np.float64).reshape(-1)
    phi, dphi, d2phi = _eval_basis(n_test, xi)
    phi_b, dphi_b, d2phi_b = _eval_basis(n_test, np.array([-1.0, 1.0]))
    return TestBasis(
        n_test=n_test,
        xi=xi,
        phi=phi,
        dphi=dphi,
        d2phi=d2phi,
        phi_b=phi_b,
        dphi_b=dphi_b,
        d2phi_b=d2phi_b,
    )
