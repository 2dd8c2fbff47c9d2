"""Variational (weak-form) residual assembly, batched over elements.

Counterpart of hpvpinns_tpu/ops/assembly.py for the Poisson-2D slice.
Res[e, k, r] = U[e, k, r] - F[e, k, r], with F the offline RHS projection
and U the network's derivative fields contracted against the
quadrature-weighted test basis (weights folded in: Wphi[n, q] = w_q phi_n).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from hpvpinns_tpu_torch.ops.contract import contract_2d


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


def poisson2d_residual(elems: Elements2D, bx: Basis1D, by: Basis1D, var_form, fields_fn):
    """Res[e, k, r] for Delta u = f on tensor-product elements.

    var_form 1:  U = -jac_y * C(phi'_r, phi_k, u_x) - jac_x * C(phi_r, phi'_k, u_y)
    with C(a, b, g) = sum_{qy,qx} w_x a(xi_qx) w_y b(eta_qy) g[qy, qx].
    Only first derivatives are needed, so the fields come firsts-only.
    `fields_fn(x, y, firsts_only=True)` is taylor_fields_2d or
    fused_fields_2d bound to the network.
    """
    if var_form != 1:
        raise NotImplementedError(
            f"Poisson-2D var_form {var_form!r} is not ported yet (ROADMAP.md: forms 0/2/'2c'); "
            "var_form 1 is"
        )
    flds = fields_fn(elems.x, elems.y, firsts_only=True)
    U = -(
        elems.jac_y[:, None, None] * contract_2d(bx.wdphi, by.wphi, flds["ux"])
        + elems.jac_x[:, None, None] * contract_2d(bx.wphi, by.wdphi, flds["uy"])
    )
    return U - elems.f_proj


def variational_loss(res: torch.Tensor, mask: torch.Tensor, n_test: torch.Tensor) -> torch.Tensor:
    """loss_v = sum_e mean_n Res[e, n]^2, inactive test indices masked out."""
    res2 = (res * mask) ** 2
    per_elem = res2.reshape(res.shape[0], -1).sum(dim=1) / n_test
    return per_elem.sum()
