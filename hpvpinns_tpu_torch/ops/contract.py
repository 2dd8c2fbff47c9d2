"""Quadrature-weighted basis contractions (counterpart of
hpvpinns_tpu/ops/contract.py; XLA einsums there, torch.einsum here):

  1D:  U[e, n]    = sum_q        Wphi[n, q] * g[e, q]
  2D:  U[e, k, r] = sum_{qy, qx} Wphi_y[k, qy] * Wphi_x[r, qx] * g[e, qy, qx]
  3D:  U[e, m, k, r] = sum_{qz, qy, qx} Wphi_z[m, qz] Wphi_y[k, qy] Wphi_x[r, qx] g[e, qz, qy, qx]

The 2D and 3D cases are sum-factorized: the fast (x) axis first, the slow
axis last.  In fp32 the products run in IEEE fp32 (TF32 off, models.mlp).

On an element x point mesh (parallel/sharding.py) the fast axis is split
over the point group: each rank holds some of the fast quadrature points
and the matching columns of the fast basis.  The one channel by which the
point Axis reaches the contractions is the fast basis tensors themselves:
shard_problem tags them (sharding.tag_points) and a contraction reads the
tag of its fast-axis operand (sharding.points_of; None off such a mesh).
It then sums its local points and all-reduces the partial sums over the
point group, before anything squares them.  A basis moved with its
dataclass's `.to` keeps the tag (ops/assembly.py); a tensor made anew from
a tagged one (`.clone()`, `.to()` on the tensor) does not.
"""

from __future__ import annotations

import torch

from hpvpinns_tpu_torch.parallel.sharding import points_of, psum


def _summed(U: torch.Tensor, wphi_fast: torch.Tensor) -> torch.Tensor:
    points = points_of(wphi_fast)
    return U if points is None else psum(U, points)


def contract_1d(wphi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """U[..., n] = sum_q wphi[n, q] * g[..., q]."""
    return _summed(torch.einsum("nq,...q->...n", wphi, g), wphi)


def contract_2d(wphi_x: torch.Tensor, wphi_y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """U[..., K, R] = sum_{qy,qx} wphi_y[K,qy] wphi_x[R,qx] g[..., qy, qx]."""
    t = torch.einsum("rx,...yx->...yr", wphi_x, g)
    return _summed(torch.einsum("ky,...yr->...kr", wphi_y, t), wphi_x)


def contract_3d(wphi_x: torch.Tensor, wphi_y: torch.Tensor, wphi_z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """U[..., M, K, R] = sum_{qz,qy,qx} wphi_z[M,qz] wphi_y[K,qy] wphi_x[R,qx]
    g[..., qz, qy, qx], in three contractions."""
    t = torch.einsum("rx,...zyx->...zyr", wphi_x, g)
    t = torch.einsum("ky,...zyr->...zkr", wphi_y, t)
    return _summed(torch.einsum("mz,...zkr->...mkr", wphi_z, t), wphi_x)
