"""Jacobi polynomial evaluation via the three-term recurrence (numpy, host).

Counterpart of hpvpinns_tpu/spectral/jacobi.py.  Everything here is an
offline float64 constant, so only the numpy branch exists.  The k-th
derivative uses the Gamma-coefficient shift identity

    d^k/dx^k P_n^{(a,b)}(x) = Gamma(a+b+n+1+k) / (2^k Gamma(a+b+n+1))
                              * P_{n-k}^{(a+k,b+k)}(x)

with the convention P_m = 0 for m < 0.
"""

from __future__ import annotations

import math

import numpy as np


def _recurrence_coeffs(n: int, a: float, b: float):
    """Coefficients (A, B, C) of  P_n = (A x + B) P_{n-1} - C P_{n-2}."""
    n2ab = 2 * n + a + b
    denom = 2 * n * (n + a + b) * (n2ab - 2)
    A = n2ab * (n2ab - 1) * (n2ab - 2) / denom
    B = (n2ab - 1) * (a * a - b * b) / denom
    C = 2 * (n + a - 1) * (n + b - 1) * n2ab / denom
    return A, B, C


def jacobi_all(nmax: int, a: float, b: float, x):
    """All Jacobi polynomials P_0..P_nmax at x, stacked on a new leading axis:
    shape (nmax+1,) + x.shape."""
    x = np.asarray(x)
    out = [np.ones_like(x)]
    if nmax >= 1:
        out.append((a - b) / 2 + (a + b + 2) / 2 * x)
    for n in range(2, nmax + 1):
        A, B, C = _recurrence_coeffs(n, a, b)
        out.append((A * x + B) * out[n - 1] - C * out[n - 2])
    return np.stack(out)


def jacobi(n: int, a: float, b: float, x):
    """P_n^{(a,b)}(x); zeros for n < 0."""
    if n < 0:
        return np.zeros_like(np.asarray(x))
    return jacobi_all(n, a, b, x)[n]


def djacobi(n: int, a: float, b: float, x, k: int = 1):
    """k-th derivative of P_n^{(a,b)} via the Gamma shift identity."""
    if n - k < 0:
        return np.zeros_like(np.asarray(x))
    c = math.exp(math.lgamma(a + b + n + 1 + k) - math.lgamma(a + b + n + 1))
    c /= 2.0**k
    return c * jacobi(n - k, a + k, b + k, x)
