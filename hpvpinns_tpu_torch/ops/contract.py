"""Quadrature-weighted basis contractions (counterpart of
hpvpinns_tpu/ops/contract.py; XLA einsums there, torch.einsum here):

  1D:  U[e, n]    = sum_q        Wphi[n, q] * g[e, q]
  2D:  U[e, k, r] = sum_{qy, qx} Wphi_y[k, qy] * Wphi_x[r, qx] * g[e, qy, qx]
  3D:  U[e, m, k, r] = sum_{qz, qy, qx} Wphi_z[m, qz] Wphi_y[k, qy] Wphi_x[r, qx] g[e, qz, qy, qx]

The 2D and 3D cases are sum-factorized: the fast (x) axis first, the slow
axis last.  In fp32 the products run in IEEE fp32 (TF32 off, models.mlp).
"""

from __future__ import annotations

import torch


def contract_1d(wphi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """U[..., n] = sum_q wphi[n, q] * g[..., q]."""
    return torch.einsum("nq,...q->...n", wphi, g)


def contract_2d(wphi_x: torch.Tensor, wphi_y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """U[..., K, R] = sum_{qy,qx} wphi_y[K,qy] wphi_x[R,qx] g[..., qy, qx]."""
    t = torch.einsum("rx,...yx->...yr", wphi_x, g)
    return torch.einsum("ky,...yr->...kr", wphi_y, t)


def contract_3d(wphi_x: torch.Tensor, wphi_y: torch.Tensor, wphi_z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """U[..., M, K, R] = sum_{qz,qy,qx} wphi_z[M,qz] wphi_y[K,qy] wphi_x[R,qx]
    g[..., qz, qy, qx], in three contractions."""
    t = torch.einsum("rx,...zyx->...zyr", wphi_x, g)
    t = torch.einsum("ky,...zyr->...zkr", wphi_y, t)
    return torch.einsum("mz,...zkr->...mkr", wphi_z, t)
