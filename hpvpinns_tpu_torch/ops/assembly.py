"""Variational (weak-form) residual assembly, batched over elements.

Counterpart of hpvpinns_tpu/ops/assembly.py for Poisson-1D/2D/3D,
Helmholtz-2D, AdvDiff, AdvDiff-2D, Burgers and the steady and unsteady
Navier-Stokes systems.  Res[e, n] (1D) / Res[e, k, r] (2D) / Res[e, m, k, r] (3D)
= U - F (the systems add an equation axis after e), with F the offline RHS
projection and U the network's derivative fields contracted against the
quadrature-weighted test basis (weights folded in: Wphi[n, q] = w_q phi_n).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from hpvpinns_tpu_torch.ops.contract import contract_1d, contract_2d, contract_3d
from hpvpinns_tpu_torch.ops.fields import (
    scalar_fields_1d, scalar_fields_2d, scalar_fields_3d, vector_fields_2d, vector_fields_3d,
)


class _Tensors:
    """`.to(device)` for a frozen dataclass whose fields are all tensors."""

    def to(self, device):
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


@dataclass(frozen=True)
class Basis1D(_Tensors):
    """Quadrature-weighted test basis on one reference axis.

    wphi/wdphi/wd2phi: [N, Q] = w_q * {phi, phi', phi''}_n(xi_q).
    dphi_b: [N, 2] unweighted phi'_n at xi = -1, +1.
    """

    wphi: torch.Tensor
    wdphi: torch.Tensor
    wd2phi: torch.Tensor
    dphi_b: torch.Tensor


@dataclass(frozen=True)
class Elements1D(_Tensors):
    """Per-element geometry + targets for a 1D assembly.

    x: [E, Q] physical quadrature points; bounds: [E, 2] element endpoints;
    jac: [E] affine jacobians (x_r - x_l) / 2; f_proj: [E, N] RHS
    projections; mask: [E, N] test-index mask; n_test: [E] test counts.
    """

    x: torch.Tensor
    bounds: torch.Tensor
    jac: torch.Tensor
    f_proj: torch.Tensor
    mask: torch.Tensor
    n_test: torch.Tensor


@dataclass(frozen=True)
class Elements2D(_Tensors):
    """Per-element geometry + targets for a tensor-product 2D assembly.

    x, y: [E, Qy, Qx] physical quadrature points (y the slow axis).
    bounds_x, bounds_y: [E, 2] per-axis element bounds.
    jac_x, jac_y: [E] per-axis jacobians.
    f_proj: [E, K, R] RHS projections; mask: [E, K, R] test-index mask;
    n_test: [E] number of active (k, r) pairs per element.
    """

    x: torch.Tensor
    y: torch.Tensor
    bounds_x: torch.Tensor
    bounds_y: torch.Tensor
    jac_x: torch.Tensor
    jac_y: torch.Tensor
    f_proj: torch.Tensor
    mask: torch.Tensor
    n_test: torch.Tensor


@dataclass(frozen=True)
class Elements3D(_Tensors):
    """Per-element geometry + targets for a tensor-product 3D assembly.

    x, y, z: [E, Qz, Qy, Qx] physical quadrature points (z slowest, x
    fastest); jac_x, jac_y, jac_z: [E] per-axis jacobians; f_proj, mask:
    [E, M, K, R]; n_test: [E].
    """

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    jac_x: torch.Tensor
    jac_y: torch.Tensor
    jac_z: torch.Tensor
    f_proj: torch.Tensor
    mask: torch.Tensor
    n_test: torch.Tensor


def poisson1d_residual(u_fn, elems: Elements1D, basis: Basis1D, var_form: int, fields_fn=None):
    """Res[e, n] for -u'' = f with test functions phi_n.

    var_form 1:  U = -jac * sum_q w u_xx phi_n
    var_form 2:  U =        sum_q w u_x  phi'_n   (the jacobians cancel)
    var_form 3:  U = -(1/jac) sum_q w u phi''_n
                     + (1/jac) [u(x_r) phi'_n(+1) - u(x_l) phi'_n(-1)]
    `fields_fn(x)` returns (u, u_x, u_xx) (taylor_fields_1d or
    fused_fields_1d bound to the network; None: the JVP engine on `u_fn`);
    `u_fn` [P, 1] -> [P, 1] gives u at the element bounds for form 3's
    boundary flux.
    """
    u, ux, uxx = fields_fn(elems.x) if fields_fn is not None else scalar_fields_1d(u_fn, elems.x)
    if var_form == 1:
        U = -elems.jac[:, None] * contract_1d(basis.wphi, uxx)
    elif var_form == 2:
        U = contract_1d(basis.wdphi, ux)
    elif var_form == 3:
        inv_jac = 1.0 / elems.jac[:, None]
        U = -inv_jac * contract_1d(basis.wd2phi, u)
        u_b = u_fn(elems.bounds.reshape(-1, 1)).reshape(elems.bounds.shape)
        flux = u_b[:, 1:2] * basis.dphi_b[None, :, 1] - u_b[:, 0:1] * basis.dphi_b[None, :, 0]
        U = U + inv_jac * flux
    else:
        raise ValueError(f"Poisson-1D var_form must be 1, 2 or 3; got {var_form}")
    return U - elems.f_proj


def _edge_values_2d(u_fn, elems: Elements2D):
    """u on the four element edges at the tangential axis's quadrature nodes:
    (u_left, u_right) each [E, Qy] at x = bounds_x, and (u_bottom, u_top)
    each [E, Qx] at y = bounds_y."""
    y_edge = elems.y[:, :, 0]  # [E, Qy] (y constant along qx)
    x_edge = elems.x[:, 0, :]  # [E, Qx] (x constant along qy)

    def eval_at(a, b):  # a, b: [E, P] -> u [E, P]
        return u_fn(torch.stack([a, b], dim=-1).reshape(-1, 2)).reshape(a.shape)

    xl = elems.bounds_x[:, 0:1].expand_as(y_edge)
    xr = elems.bounds_x[:, 1:2].expand_as(y_edge)
    yb = elems.bounds_y[:, 0:1].expand_as(x_edge)
    yt = elems.bounds_y[:, 1:2].expand_as(x_edge)
    return eval_at(xl, y_edge), eval_at(xr, y_edge), eval_at(x_edge, yb), eval_at(x_edge, yt)


def _flux_2d(u_lo, u_hi, wphi_tan, dphi_b):
    """Boundary flux [u dphi]_lo^hi integrated along the tangential axis:
    [E, K, R] = sum_q wphi_tan[k, q] (u_hi[e, q] dphi_b[r, 1]
                                      - u_lo[e, q] dphi_b[r, 0])."""
    t_hi = torch.einsum("kq,eq->ek", wphi_tan, u_hi)
    t_lo = torch.einsum("kq,eq->ek", wphi_tan, u_lo)
    return t_hi[:, :, None] * dphi_b[None, None, :, 1] - t_lo[:, :, None] * dphi_b[None, None, :, 0]


def poisson2d_residual(u_fn, elems: Elements2D, bx: Basis1D, by: Basis1D, var_form, fields_fn=None):
    """Res[e, k, r] for Delta u = f on tensor-product elements, with
    C(a, b, g) = sum_{qy,qx} w_x a(xi_qx) w_y b(eta_qy) g[qy, qx]:

    var_form 0:   U = jac * C(phi_r, phi_k, u_xx + u_yy)
    var_form 1:   U = -jac_y * C(phi'_r, phi_k, u_x) - jac_x * C(phi_r, phi'_k, u_y)
    var_form 2:   U = jac * [C(phi''_r, phi_k, u) + C(phi_r, phi''_k, u)]
                  (the reference's formula verbatim: a consistent weak form
                  only on a single [-1,1]^2 element)
    var_form "2c": U = (jac_y/jac_x) [C(phi''_r, phi_k, u) - FluxX]
                     + (jac_x/jac_y) [C(phi_r, phi''_k, u) - FluxY]
                  (the exact twice-integrated form, with the surviving
                  [u phi'] boundary fluxes from u_fn on the element edges).

    `fields_fn(x, y, firsts_only=...)` is taylor_fields_2d or
    fused_fields_2d bound to the network (None: the JVP engine on `u_fn`);
    form 1 needs first derivatives only, so its fields come firsts-only.
    `u_fn` [P, 2] -> [P, 1] is also used by form "2c" for its fluxes.
    """
    f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
    flds = f2d(elems.x, elems.y, firsts_only=(var_form == 1))
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(bx.wphi, by.wphi, flds["uxx"] + flds["uyy"])
    elif var_form == 1:
        U = -(
            elems.jac_y[:, None, None] * contract_2d(bx.wdphi, by.wphi, flds["ux"])
            + elems.jac_x[:, None, None] * contract_2d(bx.wphi, by.wdphi, flds["uy"])
        )
    elif var_form == 2:
        U = jac * (contract_2d(bx.wd2phi, by.wphi, flds["u"]) + contract_2d(bx.wphi, by.wd2phi, flds["u"]))
    elif var_form == "2c":
        u_l, u_r, u_b, u_t = _edge_values_2d(u_fn, elems)
        flux_x = _flux_2d(u_l, u_r, by.wphi, bx.dphi_b)
        flux_y = _flux_2d(u_b, u_t, bx.wphi, by.dphi_b).transpose(1, 2)
        U = (elems.jac_y / elems.jac_x)[:, None, None] * (
            contract_2d(bx.wd2phi, by.wphi, flds["u"]) - flux_x
        ) + (elems.jac_x / elems.jac_y)[:, None, None] * (
            contract_2d(bx.wphi, by.wd2phi, flds["u"]) - flux_y
        )
    else:
        raise ValueError(f"Poisson-2D var_form must be 0, 1, 2 or '2c'; got {var_form!r}")
    return U - elems.f_proj


def helmholtz2d_residual(u_fn, elems: Elements2D, bx: Basis1D, by: Basis1D, k_sq, var_form: int, fields_fn=None):
    """Res[e, k, r] for Delta u + k^2 u = f on tensor-product elements: the
    Poisson weak forms plus the zeroth-order mass term.

    var_form 0:  U = jac * C(phi_r, phi_k, u_xx + u_yy + k^2 u)
    var_form 1:  U = -jac_y * C(phi'_r, phi_k, u_x) - jac_x * C(phi_r, phi'_k, u_y)
                     + jac * k^2 * C(phi_r, phi_k, u)
                 (its fields come firsts-only)

    `k_sq` is a number or the trainable 0-d tensor params["pde"]["k_sq"];
    `fields_fn` as for poisson2d_residual."""
    f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
    flds = f2d(elems.x, elems.y, firsts_only=(var_form == 1))
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(bx.wphi, by.wphi, flds["uxx"] + flds["uyy"] + k_sq * flds["u"])
    elif var_form == 1:
        U = -(
            elems.jac_y[:, None, None] * contract_2d(bx.wdphi, by.wphi, flds["ux"])
            + elems.jac_x[:, None, None] * contract_2d(bx.wphi, by.wdphi, flds["uy"])
        ) + k_sq * jac * contract_2d(bx.wphi, by.wphi, flds["u"])
    else:
        raise ValueError(f"Helmholtz-2D var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def advdiff_residual(u_fn, elems: Elements2D, bx: Basis1D, bt: Basis1D, var_form: int, velocity, epsilon,
                     fields_fn=None, epsilon_x=0.0):
    """Res[e, k, r] for u_t + V u_x - eps u_xx = f in space-time elements
    (AdvDiff.py:161-180; the reference's F = 0).  The slow axis of
    Elements2D is time.  `velocity` and `epsilon` are numbers, 0-d tensors
    (the trainable coefficients) or fields broadcastable to [E, Qt, Qx]
    (space-dependent coefficients: they multiply the integrand inside the
    quadrature sum).

    var_form 0:  U = jac * C(phi_r, phi_k, u_t + V u_x - eps u_xx)   (:161-167)
    var_form 1:  U = jac * C(phi_r, phi_k, u_t + V u_x + eps_x u_x)
                     + jac_t * C(phi'_r, phi_k, eps u_x)             (:169-174)
                 (`epsilon_x` = d(eps)/dx; 0 for a constant eps)
    var_form 2 (scalar eps only): the diffusion term twice integrated by
                 parts, with the surviving [u phi'] boundary flux live:
                 U = jac * C(phi_r, phi_k, u_t + V u_x)
                     - eps (jac_t/jac_x) [C(phi''_r, phi_k, u) - FluxX].

    Form 0 takes its fields with first_y_only (u_xx, and u_t alone in
    time); forms 1 and 2 take them firsts-only.
    """
    f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
    kw = {"first_y_only": True} if var_form == 0 else {"firsts_only": True}
    flds = f2d(elems.x, elems.y, **kw)
    ut, ux = flds["uy"], flds["ux"]
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + velocity * ux - epsilon * flds["uxx"])
    elif var_form == 1:
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + velocity * ux + epsilon_x * ux)
        U = U + elems.jac_y[:, None, None] * contract_2d(bx.wdphi, bt.wphi, epsilon * ux)
    elif var_form == 2:
        if not (isinstance(epsilon_x, (int, float)) and epsilon_x == 0.0):
            raise ValueError("AdvDiff var_form=2 supports scalar epsilon only")
        u_l, u_r, _, _ = _edge_values_2d(u_fn, elems)
        flux_x = _flux_2d(u_l, u_r, bt.wphi, bx.dphi_b)
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + velocity * ux)
        U = U - epsilon * (elems.jac_y / elems.jac_x)[:, None, None] * (
            contract_2d(bx.wd2phi, bt.wphi, flds["u"]) - flux_x
        )
    else:
        raise ValueError(f"AdvDiff var_form must be 0, 1 or 2; got {var_form}")
    return U - elems.f_proj


def burgers_residual(u_fn, elems: Elements2D, bx: Basis1D, bt: Basis1D, var_form: int, nu, fields_fn=None):
    """Res[e, k, r] for u_t + u u_x = nu u_xx in space-time elements (F = 0),
    the convection in conservation form (u u_x = (u^2/2)_x):

    var_form 0:  U = jac * C(phi_r, phi_k, u_t + u u_x - nu u_xx)
    var_form 1:  U = jac * C(phi_r, phi_k, u_t) - (1/2) jac_t * C(phi'_r, phi_k, u^2)
                     + nu jac_t * C(phi'_r, phi_k, u_x)
                 (the x-integrations by parts drop their fluxes: phi_r(+-1) = 0)

    Form 0 takes its fields with first_y_only (u_xx, and u_t alone in time),
    form 1 firsts-only."""
    f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
    kw = {"first_y_only": True} if var_form == 0 else {"firsts_only": True}
    flds = f2d(elems.x, elems.y, **kw)
    u, ut, ux = flds["u"], flds["uy"], flds["ux"]
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    jt = elems.jac_y[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + u * ux - nu * flds["uxx"])
    elif var_form == 1:
        U = (
            jac * contract_2d(bx.wphi, bt.wphi, ut)
            - 0.5 * jt * contract_2d(bx.wdphi, bt.wphi, u * u)
            + nu * jt * contract_2d(bx.wdphi, bt.wphi, ux)
        )
    else:
        raise ValueError(f"Burgers var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def _fields_3d(u_fn, elems: Elements3D, fields_fn, second: bool):
    if fields_fn is None:
        return scalar_fields_3d(u_fn, elems.x, elems.y, elems.z, second=second)
    return fields_fn(elems.x, elems.y, elems.z, second=second)


def advdiff2d_residual(u_fn, elems: Elements3D, bx: Basis1D, by: Basis1D, bt: Basis1D, var_form: int,
                       vx, vy, epsilon, fields_fn=None, epsilon_x=0.0, epsilon_y=0.0):
    """Res[e, m, k, r] for u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f on
    (x, y, t) elements, time the slowest (z) axis; with
    C3(a, b, c, g) the quadrature sum against phi_a(x) phi_b(y) phi_c(t):

    var_form 0:  U = jac C3(phi_r, phi_k, phi_m, ut + vx ux + vy uy - eps (uxx + uyy))
    var_form 1:  U = jac C3(phi_r, phi_k, phi_m, ut + vx ux + vy uy + eps_x ux + eps_y uy)
                     + (jac/jac_x) C3(phi'_r, phi_k, phi_m, eps ux)
                     + (jac/jac_y) C3(phi_r, phi'_k, phi_m, eps uy)

    vx, vy and epsilon are numbers, 0-d tensors (trainable) or fields
    broadcastable to [E, Qt, Qy, Qx]; epsilon_x/epsilon_y are the field's
    derivatives (0 for a scalar).  Form 0 takes the fields with second
    derivatives (uzz is computed and dropped), form 1 firsts only.
    `fields_fn(x, y, z, second=...)` is taylor_fields_3d or fused_fields_3d
    bound to the network (None: the JVP engine on `u_fn`)."""
    flds = _fields_3d(u_fn, elems, fields_fn, var_form == 0)
    ut, ux, uy = flds["uz"], flds["ux"], flds["uy"]
    jac = (elems.jac_x * elems.jac_y * elems.jac_z)[:, None, None, None]
    adv = ut + vx * ux + vy * uy
    if var_form == 0:
        U = jac * contract_3d(bx.wphi, by.wphi, bt.wphi, adv - epsilon * (flds["uxx"] + flds["uyy"]))
    elif var_form == 1:
        jx = (elems.jac_y * elems.jac_z)[:, None, None, None]
        jy = (elems.jac_x * elems.jac_z)[:, None, None, None]
        U = (
            jac * contract_3d(bx.wphi, by.wphi, bt.wphi, adv + epsilon_x * ux + epsilon_y * uy)
            + jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, epsilon * ux)
            + jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, epsilon * uy)
        )
    else:
        raise ValueError(f"AdvDiff-2D var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def poisson3d_residual(u_fn, elems: Elements3D, bx: Basis1D, by: Basis1D, bz: Basis1D, var_form: int,
                       fields_fn=None):
    """Res[e, m, k, r] for Delta u = f on 3D tensor-product elements:

    var_form 0:  U = jac C(phi_r, phi_k, phi_m, u_xx + u_yy + u_zz)
    var_form 1:  U = -(jac/jac_x) C(phi'_r, phi_k, phi_m, u_x)
                     -(jac/jac_y) C(phi_r, phi'_k, phi_m, u_y)
                     -(jac/jac_z) C(phi_r, phi_k, phi'_m, u_z)

    `fields_fn` as for advdiff2d_residual; form 1 takes firsts only."""
    flds = _fields_3d(u_fn, elems, fields_fn, var_form == 0)
    jac = (elems.jac_x * elems.jac_y * elems.jac_z)[:, None, None, None]
    if var_form == 0:
        U = jac * contract_3d(bx.wphi, by.wphi, bz.wphi, flds["uxx"] + flds["uyy"] + flds["uzz"])
    elif var_form == 1:
        jx = (elems.jac_y * elems.jac_z)[:, None, None, None]
        jy = (elems.jac_x * elems.jac_z)[:, None, None, None]
        jz = (elems.jac_x * elems.jac_y)[:, None, None, None]
        U = -(
            jx * contract_3d(bx.wdphi, by.wphi, bz.wphi, flds["ux"])
            + jy * contract_3d(bx.wphi, by.wdphi, bz.wphi, flds["uy"])
            + jz * contract_3d(bx.wphi, by.wphi, bz.wdphi, flds["uz"])
        )
    else:
        raise ValueError(f"Poisson-3D var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def ns_residual(w_fn, elems: Elements2D, bx: Basis1D, by: Basis1D, var_form: int, nu, fields_fn=None):
    """Res[e, i, k, r] for the steady incompressible Navier-Stokes system

        u u_x + v u_y + p_x - nu (u_xx + u_yy) = 0     (i = 0, x-momentum)
        u v_x + v v_y + p_y - nu (v_xx + v_yy) = 0     (i = 1, y-momentum)
        u_x + v_y                              = 0     (i = 2, continuity)

    on tensor-product elements; w_fn maps [P, 2] -> [P, 3] = (u, v, p), the
    convection in convective form.

    var_form 0:  U_i = jac * C(phi_r, phi_k, strong integrand_i)
    var_form 1:  diffusion and the pressure gradient once integrated by parts:
      U_0 = jac C(phi_r, phi_k, u u_x + v u_y)
            + nu [jac_y C(phi'_r, phi_k, u_x) + jac_x C(phi_r, phi'_k, u_y)]
            - jac_y C(phi'_r, phi_k, p)
      U_1 = the same with v, and - jac_x C(phi_r, phi'_k, p)
      U_2 = jac C(phi_r, phi_k, u_x + v_y)

    Returns [E, 3, K, R]; the (zero) RHS projection broadcasts over the
    equation axis."""
    f2d = fields_fn or (lambda *a, **k: vector_fields_2d(w_fn, *a, **k))
    flds = f2d(elems.x, elems.y, firsts_only=(var_form == 1))
    w, wx, wy = flds["w"], flds["wx"], flds["wy"]
    u, v, p = w[..., 0], w[..., 1], w[..., 2]
    ux, vx, px = wx[..., 0], wx[..., 1], wx[..., 2]
    uy, vy_, py = wy[..., 0], wy[..., 1], wy[..., 2]
    conv_u = u * ux + v * uy
    conv_v = u * vx + v * vy_
    div = ux + vy_
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    jx = elems.jac_x[:, None, None]
    jy = elems.jac_y[:, None, None]
    if var_form == 0:
        wxx, wyy = flds["wxx"], flds["wyy"]
        U0 = jac * contract_2d(bx.wphi, by.wphi, conv_u + px - nu * (wxx[..., 0] + wyy[..., 0]))
        U1 = jac * contract_2d(bx.wphi, by.wphi, conv_v + py - nu * (wxx[..., 1] + wyy[..., 1]))
    elif var_form == 1:
        U0 = (
            jac * contract_2d(bx.wphi, by.wphi, conv_u)
            + nu * (jy * contract_2d(bx.wdphi, by.wphi, ux) + jx * contract_2d(bx.wphi, by.wdphi, uy))
            - jy * contract_2d(bx.wdphi, by.wphi, p)
        )
        U1 = (
            jac * contract_2d(bx.wphi, by.wphi, conv_v)
            + nu * (jy * contract_2d(bx.wdphi, by.wphi, vx) + jx * contract_2d(bx.wphi, by.wdphi, vy_))
            - jx * contract_2d(bx.wphi, by.wdphi, p)
        )
    else:
        raise ValueError(f"Navier-Stokes var_form must be 0 or 1; got {var_form}")
    U2 = jac * contract_2d(bx.wphi, by.wphi, div)
    return torch.stack([U0, U1, U2], dim=1) - elems.f_proj[:, None]


def ns_unsteady_residual(w_fn, elems: Elements3D, bx: Basis1D, by: Basis1D, bt: Basis1D, var_form: int, nu,
                         fields_fn=None):
    """Res[e, i, m, k, r] for the unsteady incompressible Navier-Stokes
    system on space-time elements (time the slowest, z, axis):

        u_t + u u_x + v u_y + p_x - nu (u_xx + u_yy) = 0   (i = 0)
        v_t + u v_x + v v_y + p_y - nu (v_xx + v_yy) = 0   (i = 1)
        u_x + v_y                                    = 0   (i = 2)

    w_fn maps [P, 3] (x, y, t) -> [P, 3] (u, v, p).

    var_form 0:  U_i = jac C3(phi_r, phi_k, phi_m, strong integrand_i)
    var_form 1:  diffusion and the pressure gradient once integrated by parts
                 in space (u_t stays strong), with jx = jac_y jac_z and
                 jy = jac_x jac_z:
      U_0 = jac C3(phi, phi, phi, u_t + u u_x + v u_y)
            + nu [jx C3(phi', phi, phi, u_x) + jy C3(phi, phi', phi, u_y)]
            - jx C3(phi', phi, phi, p)
      U_1 = the same with v, and - jy C3(phi, phi', phi, p)
      U_2 = jac C3(phi, phi, phi, u_x + v_y)

    Returns [E, 3, M, K, R]; the (zero) RHS projection broadcasts over the
    equation axis."""
    f3d = fields_fn or (lambda *a, **k: vector_fields_3d(w_fn, *a, **k))
    flds = f3d(elems.x, elems.y, elems.z, second=(var_form == 0))
    w, wx, wy, wt = flds["w"], flds["wx"], flds["wy"], flds["wz"]
    u, v = w[..., 0], w[..., 1]
    ux, vx, px = wx[..., 0], wx[..., 1], wx[..., 2]
    uy, vy_, py = wy[..., 0], wy[..., 1], wy[..., 2]
    conv_u = wt[..., 0] + u * ux + v * uy
    conv_v = wt[..., 1] + u * vx + v * vy_
    div = ux + vy_
    jac = (elems.jac_x * elems.jac_y * elems.jac_z)[:, None, None, None]
    if var_form == 0:
        wxx, wyy = flds["wxx"], flds["wyy"]
        U0 = jac * contract_3d(bx.wphi, by.wphi, bt.wphi, conv_u + px - nu * (wxx[..., 0] + wyy[..., 0]))
        U1 = jac * contract_3d(bx.wphi, by.wphi, bt.wphi, conv_v + py - nu * (wxx[..., 1] + wyy[..., 1]))
    elif var_form == 1:
        p = w[..., 2]
        jx = (elems.jac_y * elems.jac_z)[:, None, None, None]
        jy = (elems.jac_x * elems.jac_z)[:, None, None, None]
        U0 = (
            jac * contract_3d(bx.wphi, by.wphi, bt.wphi, conv_u)
            + nu * (jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, ux)
                    + jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, uy))
            - jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, p)
        )
        U1 = (
            jac * contract_3d(bx.wphi, by.wphi, bt.wphi, conv_v)
            + nu * (jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, vx)
                    + jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, vy_))
            - jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, p)
        )
    else:
        raise ValueError(f"unsteady Navier-Stokes var_form must be 0 or 1; got {var_form}")
    U2 = jac * contract_3d(bx.wphi, by.wphi, bt.wphi, div)
    return torch.stack([U0, U1, U2], dim=1) - elems.f_proj[:, None]


def variational_loss(res: torch.Tensor, mask: torch.Tensor, n_test: torch.Tensor) -> torch.Tensor:
    """loss_v = sum_e mean_n Res[e, n]^2, inactive test indices masked out."""
    res2 = (res * mask) ** 2
    per_elem = res2.reshape(res.shape[0], -1).sum(dim=1) / n_test
    return per_elem.sum()
