"""Offline assembly: host-side float64 precomputation of basis tensors,
element geometry and RHS projections.

Counterpart of hpvpinns_tpu/problems/build.py (2D).  Everything is assembled
in float64 numpy and only then cast to the training dtype and moved to the
device: the network forward and its derivatives are the only live compute.
"""

from __future__ import annotations

import numpy as np
import torch

from hpvpinns_tpu_torch.geometry.mesh import TensorMesh2D
from hpvpinns_tpu_torch.ops.assembly import Basis1D, Elements2D
from hpvpinns_tpu_torch.spectral.basis import make_test_basis


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)


def make_weighted_basis(n_test: int, xq: np.ndarray, wq: np.ndarray, dtype, device=None) -> Basis1D:
    """Basis1D with quadrature weights folded in: Wphi[n,q] = w_q phi_n(xi_q)."""
    tb = make_test_basis(n_test, xq)
    w = np.asarray(wq, dtype=np.float64).reshape(1, -1)
    return Basis1D(
        wphi=_tensor(tb.phi * w, dtype, device),
        wdphi=_tensor(tb.dphi * w, dtype, device),
        wd2phi=_tensor(tb.d2phi * w, dtype, device),
        dphi_b=_tensor(tb.dphi_b, dtype, device),
    )


def _test_mask(n_test_per_elem: np.ndarray, n_max: int):
    """mask[e, n] = 1.0 for n < n_test[e]; plus float counts [E]."""
    nt = np.asarray(n_test_per_elem, dtype=np.int64)
    mask = (np.arange(n_max)[None, :] < nt[:, None]).astype(np.float64)
    return mask, nt.astype(np.float64)


def build_elements_2d(
    mesh: TensorMesh2D,
    xq: np.ndarray,
    wq_x: np.ndarray,
    yq: np.ndarray,
    wq_y: np.ndarray,
    f_fn,
    n_test_x_per_elem,
    n_test_y_per_elem,
    dtype,
    device=None,
) -> Elements2D:
    """Tensor-product element batch with RHS projections
    F[e, k, r] = jac_e * sum_{qy,qx} wx wy f(x, y) phi_r(xi) phi_k(eta)
    (flat element order e = ex*Ey + ey).  f_fn=None gives F = 0."""
    xq = np.asarray(xq, dtype=np.float64).reshape(-1)
    yq = np.asarray(yq, dtype=np.float64).reshape(-1)
    ntx = np.asarray(n_test_x_per_elem, dtype=np.int64)
    nty = np.asarray(n_test_y_per_elem, dtype=np.int64)
    n_max_x, n_max_y = int(ntx.max()), int(nty.max())
    tbx = make_test_basis(n_max_x, xq)
    tby = make_test_basis(n_max_y, yq)

    X, Y = mesh.map_points(xq, yq)  # [E, Qy, Qx]
    jx, jy = mesh.jacobians()
    E = mesh.n_elem

    wphix = tbx.phi * np.asarray(wq_x, dtype=np.float64).reshape(1, -1)  # [R, Qx]
    wphiy = tby.phi * np.asarray(wq_y, dtype=np.float64).reshape(1, -1)  # [K, Qy]
    if f_fn is None:
        f_proj = np.zeros((E, n_max_y, n_max_x))
    else:
        f_vals = f_fn(X, Y)
        t = np.einsum("rx,eyx->eyr", wphix, f_vals)
        f_proj = (jx * jy)[:, None, None] * np.einsum("ky,eyr->ekr", wphiy, t)

    mask_x, _ = _test_mask(ntx, n_max_x)  # [Ex, R]
    mask_y, _ = _test_mask(nty, n_max_y)  # [Ey, K]
    mask = (mask_y[None, :, :, None] * mask_x[:, None, None, :]).reshape(E, n_max_y, n_max_x)
    n_test = (ntx[:, None] * nty[None, :]).reshape(E).astype(np.float64)
    f_proj = f_proj * mask

    bounds_x, bounds_y = mesh.element_bounds()
    arrays = dict(
        x=X, y=Y, bounds_x=bounds_x, bounds_y=bounds_y, jac_x=jx, jac_y=jy,
        f_proj=f_proj, mask=mask, n_test=n_test,
    )
    return Elements2D(**{k: _tensor(v, dtype, device) for k, v in arrays.items()})
