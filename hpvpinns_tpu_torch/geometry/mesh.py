"""hp-domain-decomposition geometry: element grids, affine maps, jacobians.

Counterpart of hpvpinns_tpu/geometry/mesh.py (1D, 2D and 3D).  The reference
element xi in [-1, 1] maps to x = center_e + jac_e * xi with jacobian
(x_{e+1} - x_e) / 2 per axis; per-element quantities carry a leading element
axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def uniform_grid(lo: float, hi: float, n_elem: int) -> np.ndarray:
    """Uniform element boundaries."""
    return lo + (hi - lo) / n_elem * np.arange(n_elem + 1, dtype=np.float64)


@dataclass(frozen=True)
class Interval1D:
    """A 1D element partition; grid: [E+1] boundaries (possibly non-uniform)."""

    grid: np.ndarray

    def __post_init__(self):
        grid = np.asarray(self.grid, dtype=np.float64)
        object.__setattr__(self, "grid", grid)
        if grid.ndim != 1 or len(grid) < 2:
            raise ValueError(f"grid needs >= 2 boundaries, got shape {grid.shape}")
        if not np.all(np.diff(grid) > 0):
            raise ValueError(f"grid must be strictly increasing, got {grid}")

    @classmethod
    def uniform(cls, lo: float, hi: float, n_elem: int) -> "Interval1D":
        return cls(grid=uniform_grid(lo, hi, n_elem))

    @classmethod
    def grid_or_uniform(cls, grid, lo: float, hi: float, n_elem: int) -> "Interval1D":
        """The boundaries `grid` where a config gives them, else `n_elem`
        uniform elements on [lo, hi]."""
        return cls(np.asarray(grid, dtype=np.float64)) if grid is not None else cls.uniform(lo, hi, n_elem)

    @property
    def n_elem(self) -> int:
        return len(self.grid) - 1

    @property
    def jacobians(self) -> np.ndarray:
        """[E] per-element jacobian (x_{e+1} - x_e) / 2."""
        return np.diff(self.grid) / 2.0

    @property
    def centers(self) -> np.ndarray:
        return (self.grid[:-1] + self.grid[1:]) / 2.0

    def map_points(self, xi: np.ndarray) -> np.ndarray:
        """Map reference points xi [Q] into every element: [E, Q]."""
        xi = np.asarray(xi, dtype=np.float64).reshape(-1)
        return self.centers[:, None] + self.jacobians[:, None] * xi[None, :]

    def element_bounds(self) -> np.ndarray:
        """[E, 2] physical (left, right) endpoints of each element."""
        return np.stack([self.grid[:-1], self.grid[1:]], axis=-1)

    def locate(self, x: np.ndarray) -> np.ndarray:
        """Element index containing each x (the last element holds the
        right end)."""
        idx = np.searchsorted(self.grid, x, side="right") - 1
        return np.clip(idx, 0, self.n_elem - 1)


@dataclass(frozen=True)
class TensorMesh2D:
    """Tensor-product 2D partition, elements enumerated flat with
    e = ex * E_y + ey (x-major)."""

    axis_x: Interval1D
    axis_y: Interval1D

    @classmethod
    def uniform(cls, xlo, xhi, nex, ylo, yhi, ney) -> "TensorMesh2D":
        return cls(
            axis_x=Interval1D.uniform(xlo, xhi, nex),
            axis_y=Interval1D.uniform(ylo, yhi, ney),
        )

    @property
    def n_elem(self) -> int:
        return self.axis_x.n_elem * self.axis_y.n_elem

    @property
    def shape(self):
        return (self.axis_x.n_elem, self.axis_y.n_elem)

    def jacobians(self):
        """Per-axis jacobians for every flat element: ([E], [E])."""
        jx = np.repeat(self.axis_x.jacobians, self.axis_y.n_elem)
        jy = np.tile(self.axis_y.jacobians, self.axis_x.n_elem)
        return jx, jy

    def element_bounds(self):
        """Per-axis physical bounds for every flat element: ([E, 2], [E, 2])."""
        bx = np.repeat(self.axis_x.element_bounds(), self.axis_y.n_elem, axis=0)
        by = np.tile(self.axis_y.element_bounds(), (self.axis_x.n_elem, 1))
        return bx, by

    def map_points(self, xi: np.ndarray, eta: np.ndarray):
        """Map the reference tensor grid (xi [Qx], eta [Qy]) into every
        element: (X, Y) each [E, Qy, Qx], y the slow point axis
        (q = qy * Qx + qx)."""
        Xx = self.axis_x.map_points(xi)
        Yy = self.axis_y.map_points(eta)
        Ex, Qx = Xx.shape
        Ey, Qy = Yy.shape
        X = np.broadcast_to(Xx[:, None, None, :], (Ex, Ey, Qy, Qx)).reshape(Ex * Ey, Qy, Qx)
        Y = np.broadcast_to(Yy[None, :, :, None], (Ex, Ey, Qy, Qx)).reshape(Ex * Ey, Qy, Qx)
        return np.ascontiguousarray(X), np.ascontiguousarray(Y)


@dataclass(frozen=True)
class TensorMesh3D:
    """Tensor-product 3D partition (x, y, z), elements enumerated flat with
    e = (ex * E_y + ey) * E_z + ez (x-major, as in 2D).  Each axis is an
    Interval1D, uniform or not (AdvDiff-2D's grid_x/grid_y/grid_t)."""

    axis_x: Interval1D
    axis_y: Interval1D
    axis_z: Interval1D

    @classmethod
    def uniform(cls, xlo, xhi, nex, ylo, yhi, ney, zlo, zhi, nez) -> "TensorMesh3D":
        return cls(
            axis_x=Interval1D.uniform(xlo, xhi, nex),
            axis_y=Interval1D.uniform(ylo, yhi, ney),
            axis_z=Interval1D.uniform(zlo, zhi, nez),
        )

    @property
    def n_elem(self) -> int:
        return self.axis_x.n_elem * self.axis_y.n_elem * self.axis_z.n_elem

    @property
    def shape(self):
        return (self.axis_x.n_elem, self.axis_y.n_elem, self.axis_z.n_elem)

    def jacobians(self):
        """Per-axis jacobians for every flat element: ([E], [E], [E])."""
        Ex, Ey, Ez = self.shape
        jx = np.repeat(self.axis_x.jacobians, Ey * Ez)
        jy = np.tile(np.repeat(self.axis_y.jacobians, Ez), Ex)
        jz = np.tile(self.axis_z.jacobians, Ex * Ey)
        return jx, jy, jz

    def map_points(self, xi: np.ndarray, eta: np.ndarray, zeta: np.ndarray):
        """Map the reference tensor grid into every element: (X, Y, Z) each
        [E, Qz, Qy, Qx], z the slowest point axis and x the fastest."""
        Xx = self.axis_x.map_points(xi)  # [Ex, Qx]
        Yy = self.axis_y.map_points(eta)  # [Ey, Qy]
        Zz = self.axis_z.map_points(zeta)  # [Ez, Qz]
        (Ex, Qx), (Ey, Qy), (Ez, Qz) = Xx.shape, Yy.shape, Zz.shape
        E, shape = Ex * Ey * Ez, (Ex, Ey, Ez, Qz, Qy, Qx)
        X = np.broadcast_to(Xx[:, None, None, None, None, :], shape).reshape(E, Qz, Qy, Qx)
        Y = np.broadcast_to(Yy[None, :, None, None, :, None], shape).reshape(E, Qz, Qy, Qx)
        Z = np.broadcast_to(Zz[None, None, :, :, None, None], shape).reshape(E, Qz, Qy, Qx)
        return np.ascontiguousarray(X), np.ascontiguousarray(Y), np.ascontiguousarray(Z)
