"""Offline assembly: host-side float64 precomputation of basis tensors,
element geometry and RHS projections.

Counterpart of hpvpinns_tpu/problems/build.py (1D, 2D and 3D).  Everything is assembled
in float64 numpy and only then cast to the training dtype and moved to the
device: the network forward and its derivatives are the only live compute.
"""

from __future__ import annotations

import numpy as np
import torch

from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D, TensorMesh3D
from hpvpinns_tpu_torch.ops.assembly import Basis1D, Elements1D, Elements2D, Elements3D
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


def build_elements_1d(
    mesh: Interval1D,
    xq: np.ndarray,
    wq: np.ndarray,
    f_fn,
    n_test_per_elem,
    dtype,
    device=None,
) -> Elements1D:
    """1D element batch with RHS projections
    F[e, n] = jac_e * sum_q w_q f(x^e_q) phi_n(xi_q)."""
    xq = np.asarray(xq, dtype=np.float64).reshape(-1)
    wq = np.asarray(wq, dtype=np.float64).reshape(-1)
    n_test_per_elem = np.asarray(n_test_per_elem, dtype=np.int64)
    tb = make_test_basis(int(n_test_per_elem.max()), xq)

    x_elem = mesh.map_points(xq)  # [E, Q]
    jac = mesh.jacobians
    f_proj = jac[:, None] * np.einsum("nq,eq->en", tb.phi * wq[None, :], f_fn(x_elem))
    mask, n_test = _test_mask(n_test_per_elem, int(n_test_per_elem.max()))
    arrays = dict(
        x=x_elem, bounds=mesh.element_bounds(), jac=jac, f_proj=f_proj * mask, mask=mask, n_test=n_test,
    )
    return Elements1D(**{k: _tensor(v, dtype, device) for k, v in arrays.items()})


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


def build_elements_3d(
    mesh: TensorMesh3D,
    xq: np.ndarray,
    wq: np.ndarray,
    f_fn,
    n_test_x,
    n_test_y,
    n_test_z,
    dtype,
    device=None,
) -> Elements3D:
    """3D element batch (the same quadrature rule on every axis) with RHS
    projections
    F[e, m, k, r] = jac_e sum_q wx wy wz f(x, y, z) phi_r(xi) phi_k(eta) phi_m(zeta)
    (flat element order e = (ex*Ey + ey)*Ez + ez).  n_test_* are ints or
    per-axis-element arrays, masked as in 1D/2D; f_fn=None gives F = 0."""
    xq = np.asarray(xq, dtype=np.float64).reshape(-1)
    wq = np.asarray(wq, dtype=np.float64).reshape(-1)
    Ex, Ey, Ez = mesh.shape
    ntx = np.broadcast_to(np.asarray(n_test_x, dtype=np.int64), (Ex,))
    nty = np.broadcast_to(np.asarray(n_test_y, dtype=np.int64), (Ey,))
    ntz = np.broadcast_to(np.asarray(n_test_z, dtype=np.int64), (Ez,))
    n_max_x, n_max_y, n_max_z = int(ntx.max()), int(nty.max()), int(ntz.max())
    tbx, tby, tbz = (make_test_basis(n, xq) for n in (n_max_x, n_max_y, n_max_z))

    X, Y, Z = mesh.map_points(xq, xq, xq)  # [E, Qz, Qy, Qx]
    jx, jy, jz = mesh.jacobians()
    E = mesh.n_elem

    w = wq[None, :]
    if f_fn is None:
        f_proj = np.zeros((E, n_max_z, n_max_y, n_max_x))
    else:
        t = np.einsum("rx,ezyx->ezyr", tbx.phi * w, f_fn(X, Y, Z))
        t = np.einsum("ky,ezyr->ezkr", tby.phi * w, t)
        f_proj = (jx * jy * jz)[:, None, None, None] * np.einsum("mz,ezkr->emkr", tbz.phi * w, t)
    mx = (np.arange(n_max_x)[None, :] < ntx[:, None]).astype(np.float64)  # [Ex, R]
    my = (np.arange(n_max_y)[None, :] < nty[:, None]).astype(np.float64)  # [Ey, K]
    mz = (np.arange(n_max_z)[None, :] < ntz[:, None]).astype(np.float64)  # [Ez, M]
    mask = np.einsum("cm,bk,ar->abcmkr", mz, my, mx).reshape(E, n_max_z, n_max_y, n_max_x)
    n_test = (ntx[:, None, None] * nty[None, :, None] * ntz[None, None, :]).reshape(E).astype(np.float64)
    arrays = dict(x=X, y=Y, z=Z, jac_x=jx, jac_y=jy, jac_z=jz, f_proj=f_proj * mask, mask=mask, n_test=n_test)
    return Elements3D(**{k: _tensor(v, dtype, device) for k, v in arrays.items()})
