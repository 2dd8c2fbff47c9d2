"""Variational (weak-form) residual assembly, batched over elements.

Counterpart of hpvpinns_tpu/ops/assembly.py for Poisson-1D, Poisson-2D and
AdvDiff.  Res[e, n] (1D) / Res[e, k, r] (2D) = U - F, with F the offline RHS
projection and U the network's derivative fields contracted against the
quadrature-weighted test basis (weights folded in: Wphi[n, q] = w_q phi_n).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from hpvpinns_tpu_torch.ops.contract import contract_1d, contract_2d
from hpvpinns_tpu_torch.ops.fields import scalar_fields_1d, scalar_fields_2d


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


def variational_loss(res: torch.Tensor, mask: torch.Tensor, n_test: torch.Tensor) -> torch.Tensor:
    """loss_v = sum_e mean_n Res[e, n]^2, inactive test indices masked out."""
    res2 = (res * mask) ** 2
    per_elem = res2.reshape(res.shape[0], -1).sum(dim=1) / n_test
    return per_elem.sum()
