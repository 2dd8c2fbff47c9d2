"""Configuration objects: the Poisson-1D and Poisson-2D subset of
hpvpinns_tpu/config.py.

Same frozen dataclasses, fields and defaults, so a JAX configuration maps one
to one.  Fields whose feature is not ported yet (Gauss-Newton,
checkpointing, hard BC, PINN scheme, matmul precision "high"/"default") are
kept and rejected with NotImplementedError where they are used; ROADMAP.md
lists them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class TrainConfig:
    """Optimization loop settings: full-batch Adam, then optionally L-BFGS,
    with the loss polled every `check_every` iterations and an optional
    threshold early stop."""

    learning_rate: float = 1e-3
    iterations: int = 1001
    lbfgs_iterations: int = 0  # second-phase full-batch L-BFGS
    gn_iterations: int = 0  # third-phase Gauss-Newton/LM: not ported yet
    gn_damping_init: float = 1e-3
    gn_solve: Optional[str] = None
    gn_cg_tol: float = 1e-3
    gn_cg_maxiter: Optional[int] = None
    gn_jac_chunk: Optional[int] = None
    threshold: Optional[float] = None  # early stop when loss < threshold
    check_every: int = 10  # host-side loss poll cadence
    log_every: int = 100  # console print cadence
    seed: int = 1234
    best_snapshot_fraction: Optional[float] = None  # keep the best params
    # over the final (1 - fraction) of the iterations
    checkpoint_dir: Optional[str] = None  # checkpointing: not ported yet
    checkpoint_every: Optional[int] = None
    checkpoint_keep_last: int = 3
    checkpoint_async: bool = False


@dataclass(frozen=True)
class Poisson1DConfig:
    """1D Poisson -u'' = f on [-1, 1] (main/Poisson-1D)."""

    layers: Tuple[int, ...] = (1, 20, 20, 20, 20, 1)
    activation: str = "sin"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32 matmuls, TF32 off
    var_form: int = 1  # 1 | 2 | 3 (zero/one/two integrations by parts)
    n_elements: int = 1
    grid: Optional[Tuple[float, ...]] = None  # non-uniform element boundaries
    n_test: int = 60
    n_test_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 80
    lossb_weight: float = 1.0
    hard_bc: bool = False  # not ported yet
    domain: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "pallas" (the fused CUDA kernels)
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=1001, threshold=2e-32)
    )


@dataclass(frozen=True)
class Poisson2DConfig:
    """2D Poisson Delta u = f on [-1, 1]^2 (main/Poisson-2D)."""

    layers: Tuple[int, ...] = (2, 5, 5, 5, 1)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32 matmuls, TF32 off
    scheme: str = "VPINNs"  # 'VPINNs' ('PINNs' not ported yet)
    var_form: object = 1  # 0 | 1 | 2 | "2c"
    n_elements_x: int = 4
    n_elements_y: int = 4
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x boundaries
    grid_y: Optional[Tuple[float, ...]] = None
    n_test_x: int = 5
    n_test_y: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 10  # per axis per element
    n_bound: int = 80  # boundary points per edge
    n_residual: int = 100  # PINN-mode collocation points
    lossb_weight: float = 10.0
    hard_bc: bool = False  # not ported yet
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "pallas" (the fused CUDA kernel)
    train: TrainConfig = field(default_factory=lambda: TrainConfig(iterations=10001))


def poisson1d_of_record() -> Poisson1DConfig:
    """Poisson-1D.py:231-240."""
    return Poisson1DConfig()


def poisson1d_quality() -> Poisson1DConfig:
    """The reference's non-uniform 3-element hp grid (Poisson-1D.py:270-273),
    p = 30, a (1,30,30,30,1) sin net, Adam 5k + L-BFGS 5k."""
    return Poisson1DConfig(
        grid=(-1.0, -0.1, 0.1, 1.0),
        n_elements=3,
        n_test=30,
        layers=(1, 30, 30, 30, 1),
        train=TrainConfig(iterations=5000, lbfgs_iterations=5000, check_every=200),
    )


def poisson2d_of_record() -> Poisson2DConfig:
    """Poisson-2D.py:279-288,434."""
    return Poisson2DConfig()


def poisson2d_quality(hard_bc: bool = False) -> Poisson2DConfig:
    """(2,48x4,1) tanh net, 10x10 test functions, 16-point quadrature,
    Adam 10k + L-BFGS 5k (hard_bc, 20k L-BFGS, is not ported yet)."""
    return Poisson2DConfig(
        layers=(2, 48, 48, 48, 48, 1),
        n_test_x=10,
        n_test_y=10,
        n_quad=16,
        hard_bc=hard_bc,
        train=TrainConfig(
            iterations=10000,
            lbfgs_iterations=20000 if hard_bc else 5000,
            check_every=1000,
        ),
    )


def poisson2d_scaled(n_elem_axis: int = 8, n_quad: int = 16, n_test: int = 10) -> Poisson2DConfig:
    """The scaled benchmark config: n_elem_axis^2 elements, higher
    quadrature/test order, a (2,20,20,20,1) net."""
    return Poisson2DConfig(
        n_elements_x=n_elem_axis,
        n_elements_y=n_elem_axis,
        n_test_x=n_test,
        n_test_y=n_test,
        n_quad=n_quad,
        layers=(2, 20, 20, 20, 1),
        train=TrainConfig(iterations=2001),
    )


__all__ = [
    "TrainConfig",
    "Poisson1DConfig",
    "Poisson2DConfig",
    "poisson1d_of_record",
    "poisson1d_quality",
    "poisson2d_of_record",
    "poisson2d_quality",
    "poisson2d_scaled",
    "replace",
]
