"""Configuration objects: the Poisson-1D, Poisson-2D and AdvDiff subset of
hpvpinns_tpu/config.py.

Same frozen dataclasses, fields and defaults, so a JAX configuration maps one
to one.  Fields whose feature is not ported yet (Gauss-Newton,
checkpointing, matmul precision "high"/"default", the adaptive slope) are
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
    hard_bc: bool = False  # lifted ansatz u = g + D N (the fields then come from "jvp")
    domain: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "jvp" | "pallas" (the fused CUDA kernels)
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
    scheme: str = "VPINNs"  # 'VPINNs' | 'PINNs' (strong-form collocation)
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
    hard_bc: bool = False  # lifted ansatz u = g + D N (the fields then come from "jvp")
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "jvp" | "pallas" (the fused CUDA kernels)
    train: TrainConfig = field(default_factory=lambda: TrainConfig(iterations=10001))


@dataclass(frozen=True)
class AdvDiffConfig:
    """Space-time advection-diffusion u_t + V u_x - eps u_xx = 0 on
    [-1, 1] x [0, T], inverse identification of eps
    (main/AdvDiff-Identification)."""

    layers: Tuple[int, ...] = (2, 5, 5, 5, 1)
    activation: str = "tanh"  # AdvDiff.py:226
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32 matmuls, TF32 off
    var_form: int = 0  # 0 | 1 (AdvDiff.py:38) | 2 (twice-IBP diffusion with a
    # live boundary flux; scalar eps)
    n_elements_x: int = 1
    n_elements_t: int = 1
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x-element boundaries
    grid_t: Optional[Tuple[float, ...]] = None  # non-uniform t-element boundaries
    n_test_x: int = 5
    n_test_t: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 10
    n_bound: int = 80  # per side/initial edge (AdvDiff.py:357-384)
    lossb_weight: float = 10.0  # folded into lossb in the reference (AdvDiff.py:184)
    velocity: float = 1.0  # V (AdvDiff.py:43)
    velocity_trainable: bool = False  # also identify V, from velocity_init
    velocity_init: float = 0.5
    velocity_model: str = "scalar"  # "scalar" | "linear" | "quadratic":
    # V(x) = v0 [+ v1 x [+ v2 x^2]] when velocity_trainable
    gamma: float = 0.1  # true eps = gamma / pi (AdvDiff.py:41-42)
    epsilon_init: float = 1.0  # trainable start (AdvDiff.py:63)
    epsilon_model: str = "scalar"  # "scalar" | "quadratic" (eps(x) = c0 +
    # c1 x + c2 x^2) | "mlp" (a small tanh network eps(x), started flat at
    # epsilon_init)
    epsilon_mlp_layers: Tuple[int, ...] = (1, 8, 8, 1)  # the eps(x) network
    epsilon_reg: float = 0.0  # Tikhonov smoothness on field eps models:
    # loss += epsilon_reg * mean_q eps'(x_q)^2
    inverse: bool = True  # eps trainable; False freezes it at the true value
    hard_bc: bool = False  # lifted space-time ansatz u = g + D(x,t) N: the
    # IC and BC hold exactly (the fields then come from "jvp")
    layer_feature: bool = False  # the outflow-layer profile
    # exp(V (x - x_out)/eps_true) as an extra network input (forward runs
    # only; the fields then come from "jvp")
    layer_feature_scale: Optional[float] = None  # its width (default eps_true/|V|)
    n_sensors_per_station: int = 5  # interior data for identifiability
    sensor_stations: Tuple[float, ...] = (-0.5, 0.0, 0.5)  # AdvDiff.py:464-479
    sensor_noise_std: float = 0.0  # additive N(0, std) on sensor readings only
    t_final: float = 1.0
    t_start: float = 0.0  # time-slab lower edge; the IC is placed at t_start
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    fourier_terms: int = 800  # exact-solution series truncation (AdvDiff.py:416)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "jvp" | "pallas" (the fused CUDA kernels)
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            iterations=1501, threshold=2e-11, best_snapshot_fraction=0.9
        )
    )


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
    Adam 10k + L-BFGS 5k; hard_bc=True lifts the ansatz and runs 20k
    L-BFGS."""
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


def advdiff_of_record() -> AdvDiffConfig:
    """AdvDiff.py:35-53."""
    return AdvDiffConfig()


def advdiff_quality() -> AdvDiffConfig:
    """float64 Adam 5k + L-BFGS 10k: the JAX package's identification
    winner (eps to 2.4% of truth).  On the card it runs in float64 under
    "taylor" (the CUDA kernels take float32)."""
    return AdvDiffConfig(
        dtype="float64",
        train=TrainConfig(
            iterations=5000,
            lbfgs_iterations=10000,
            check_every=500,
            best_snapshot_fraction=0.9,
        ),
    )


def advdiff_precision() -> AdvDiffConfig:
    """The reference's inverse configuration with a 150-step Gauss-Newton/LM
    phase after Adam 1500 (float64); its gn_iterations raise in `train`
    until the Gauss-Newton phase is ported."""
    return AdvDiffConfig(
        dtype="float64",
        train=TrainConfig(iterations=1500, gn_iterations=150, check_every=300),
    )


def advdiff_forward_precision() -> AdvDiffConfig:
    """The forward frontier: the outflow-layer input feature, a
    front-clustered x-grid and a 150-step QR-LM phase; its gn_iterations
    raise in `train` until the Gauss-Newton phase is ported."""
    return AdvDiffConfig(
        inverse=False,
        layer_feature=True,
        layers=(2, 32, 32, 32, 1),
        grid_x=(-1.0, 0.5, 0.9, 1.0),
        n_test_x=10,
        n_test_t=10,
        n_quad=16,
        train=TrainConfig(
            iterations=1500, gn_iterations=150, gn_solve="qr", check_every=300
        ),
    )


__all__ = [
    "AdvDiffConfig",
    "TrainConfig",
    "Poisson1DConfig",
    "Poisson2DConfig",
    "advdiff_forward_precision",
    "advdiff_of_record",
    "advdiff_precision",
    "advdiff_quality",
    "poisson1d_of_record",
    "poisson1d_quality",
    "poisson2d_of_record",
    "poisson2d_quality",
    "poisson2d_scaled",
    "replace",
]
