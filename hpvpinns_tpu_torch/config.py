"""Configuration objects: the Poisson-1D, Poisson-2D, Poisson-3D, Helmholtz-2D,
AdvDiff, AdvDiff-2D, Burgers, Kovasznay and Taylor-Green subset of
hpvpinns_tpu/config.py.

Same frozen dataclasses, fields and defaults, so a JAX configuration maps one
to one.  matmul_precision "high"/"default" is TF32 on the card for the
network's products only (models/mlp.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class TrainConfig:
    """Optimization loop settings: full-batch Adam, then optionally L-BFGS
    and Gauss-Newton/LM, with the loss polled every `check_every` iterations,
    an optional threshold early stop and optional checkpoints."""

    learning_rate: float = 1e-3
    iterations: int = 1001
    lbfgs_iterations: int = 0  # second-phase full-batch L-BFGS
    gn_iterations: int = 0  # third-phase Gauss-Newton/LM: accepted steps
    gn_damping_init: float = 1e-3  # initial LM damping lambda
    gn_solve: Optional[str] = None  # "normal" | "host" | "qr" | "cg" | "lsqr"; None: "host" below f64, else "normal"
    gn_cg_tol: float = 1e-3  # matrix-free solves: relative forcing tolerance
    gn_cg_maxiter: Optional[int] = None  # matrix-free iteration cap (None: min(P, 2000))
    gn_jac_chunk: Optional[int] = None  # Jacobian passes per vmapped block (None: all up to 2048, else 256)
    threshold: Optional[float] = None  # early stop when loss < threshold
    check_every: int = 10  # host-side loss poll cadence
    log_every: int = 100  # console print cadence
    seed: int = 1234
    best_snapshot_fraction: Optional[float] = None  # keep the best params
    # over the final (1 - fraction) of the iterations
    checkpoint_dir: Optional[str] = None  # torch.save checkpoints (training/checkpoint.py)
    checkpoint_every: Optional[int] = None
    checkpoint_keep_last: int = 3  # retained checkpoints (0 = keep all)
    checkpoint_async: bool = False  # write on a background thread


@dataclass(frozen=True)
class Poisson1DConfig:
    """1D Poisson -u'' = f on [-1, 1] (main/Poisson-1D)."""

    layers: Tuple[int, ...] = (1, 20, 20, 20, 20, 1)
    activation: str = "sin"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
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
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
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
class Helmholtz2DConfig:
    """2D Helmholtz Delta u + k^2 u = f on [-1, 1]^2: the oscillatory,
    indefinite extension of the Poisson family.  The benchmark solution is
    the tilted plane wave u = sin(k (x cos th + y sin th) + phase), an exact
    homogeneous solution (f = 0) driven through its boundary trace; k = 9
    puts k^2 = 81 between two Dirichlet-Laplacian eigenvalues.
    `inverse=True` makes k^2 a trainable pde leaf identified from interior
    sensors."""

    layers: Tuple[int, ...] = (2, 30, 30, 30, 1)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
    var_form: int = 1  # 0 | 1 (Laplacian once integrated by parts; the mass term needs no derivatives)
    n_elements_x: int = 4
    n_elements_y: int = 4
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x boundaries (overrides n_elements_x)
    grid_y: Optional[Tuple[float, ...]] = None
    n_test_x: int = 10
    n_test_y: int = 10
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 16  # per axis per element
    n_bound: int = 80  # boundary points per edge
    lossb_weight: float = 10.0
    k: float = 9.0  # true wavenumber (k^2 is the PDE coefficient)
    wave_angle_deg: float = 30.0  # plane-wave direction
    wave_phase: float = 0.3
    inverse: bool = False  # k^2 trainable from interior sensors
    k_sq_init: float = 60.0  # trainable start (true k^2 = 81)
    n_sensors: int = 60  # LHS interior sensor points when inverse
    sensor_noise_std: float = 0.0  # additive N(0, std) on the sensor readings
    hard_bc: bool = False  # lifted ansatz u = Coons(boundary trace) + (1-xi^2)(1-eta^2) N (the fields then come from "jvp")
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
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
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


@dataclass(frozen=True)
class Poisson3DConfig:
    """3D Poisson Delta u = f on [-1, 1]^3: the volumetric generalization of
    the tensor-product architecture (no reference analog)."""

    layers: Tuple[int, ...] = (3, 20, 20, 20, 1)
    activation: str = "tanh"
    var_form: int = 1  # 0 | 1
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
    n_elements_x: int = 2
    n_elements_y: int = 2
    n_elements_z: int = 2
    n_test_x: int = 5
    n_test_y: int = 5
    n_test_z: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_test_z_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 8  # per axis per element
    n_bound: int = 100  # boundary points per face (6 faces)
    lossb_weight: float = 10.0
    hard_bc: bool = False  # lifted ansatz u = g + D N: all six faces exact ("jvp")
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    domain_z: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "jvp" | "pallas" (the fused CUDA kernels)
    train: TrainConfig = field(default_factory=lambda: TrainConfig(iterations=5001))


@dataclass(frozen=True)
class AdvDiff2DConfig:
    """2D space-time advection-diffusion

        u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f

    on [-1, 1]^2 x [0, T], assembled on the 3D tensor machinery (time the
    slowest axis), with the manufactured solution u = sin(pi x) sin(pi y)
    e^{-t}; eps (and optionally the velocity vector) are identified from
    interior sensors."""

    layers: Tuple[int, ...] = (3, 16, 16, 16, 1)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
    var_form: int = 1  # 0 | 1 (both diffusion terms once integrated by parts)
    n_elements_x: int = 1
    n_elements_y: int = 1
    n_elements_t: int = 1
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform element boundaries per axis
    grid_y: Optional[Tuple[float, ...]] = None
    grid_t: Optional[Tuple[float, ...]] = None
    n_test_x: int = 5
    n_test_y: int = 5
    n_test_t: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 8  # per axis per element
    n_bound: int = 80  # per face (4 side walls + the t = 0 face)
    lossb_weight: float = 10.0
    velocity: Tuple[float, float] = (1.0, 0.5)  # true (vx, vy)
    velocity_trainable: bool = False  # also identify (vx, vy), from velocity_init
    velocity_init: Tuple[float, float] = (0.5, 0.25)
    gamma: float = 0.1  # true eps = gamma / pi
    epsilon_init: float = 1.0
    inverse: bool = True  # eps trainable; False freezes it at the true value
    sensor_stations: Tuple[Tuple[float, float], ...] = (
        (-0.5, -0.5), (-0.5, 0.5), (0.0, 0.0), (0.5, -0.5), (0.5, 0.5),
    )  # interior (x, y) stations
    n_sensors_per_station: int = 5  # LHS times per station
    sensor_noise_std: float = 0.0
    t_final: float = 1.0
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "jvp" | "pallas" (the fused CUDA kernels)
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            iterations=3000, check_every=100, best_snapshot_fraction=0.9
        )
    )


@dataclass(frozen=True)
class BurgersConfig:
    """Viscous Burgers u_t + u u_x = nu u_xx on [-1, 1] x [0, T],
    u(x, 0) = -sin(pi x), u(+-1, t) = 0: the nonlinear space-time family
    (nu = 0.01/pi develops a steep interior front at x = 0)."""

    layers: Tuple[int, ...] = (2, 20, 20, 20, 20, 1)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
    var_form: int = 1  # 0 | 1 (conservation-form convection integrated by parts)
    n_elements_x: int = 4
    n_elements_t: int = 2
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x boundaries (overrides n_elements_x)
    grid_t: Optional[Tuple[float, ...]] = None  # non-uniform t boundaries (overrides n_elements_t)
    n_test_x: int = 8
    n_test_t: int = 8
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 16
    n_bound: int = 80  # per side and on the initial edge
    lossb_weight: float = 10.0
    nu: float = 0.01 / 3.141592653589793
    hard_bc: bool = False  # lifted ansatz: IC and BC exact (the fields then come from "jvp")
    front_feature: bool = False  # append tanh(x / delta) as a network input (forces "jvp")
    front_feature_scale: Optional[float] = None  # delta; None: 2 nu
    n_strong: int = 0  # strong-form collocation points (a weak + strong loss); 0: pure variational
    strong_weight: float = 1.0  # weight of the strong-residual term
    strong_window: Optional[Tuple[float, float]] = None  # x-range of the collocation points; None: the domain
    t_final: float = 1.0
    t_start: float = 0.0  # time-slab lower edge (IC at t_start: Cole-Hopf values, or build(..., ic_fn=))
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" | "jvp" | "pallas" (the fused CUDA kernels)
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=5000, check_every=100)
    )


@dataclass(frozen=True)
class KovasznayConfig:
    """Steady incompressible Navier-Stokes, Kovasznay flow (Re = 1/nu):

        (w . grad) w + grad p = nu Lap w,   div w = 0,   w = (u, v)

    on [x_l, x_r] x [y_l, y_r], with the exact laminar wake solution
    (Kovasznay 1948)

        lam = Re/2 - sqrt(Re^2/4 + 4 pi^2)
        u = 1 - e^{lam x} cos(2 pi y),  v = (lam / 2 pi) e^{lam x} sin(2 pi y)
        p = (1 - e^{2 lam x}) / 2.

    A system of coupled PDEs: one (u, v, p) ansatz against the stacked
    momentum and continuity weak residual (ops/assembly.py::ns_residual)."""

    layers: Tuple[int, ...] = (2, 30, 30, 30, 3)  # (u, v, p) output triple
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
    var_form: int = 1  # 0 | 1 (once-IBP diffusion + pressure gradient)
    re: float = 40.0  # Reynolds number; nu = 1/re
    n_elements_x: int = 2
    n_elements_y: int = 2
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x-element bounds
    grid_y: Optional[Tuple[float, ...]] = None
    n_test_x: int = 8
    n_test_y: int = 8
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 14
    n_bound: int = 60  # LHS boundary points per edge
    lossb_weight: float = 10.0
    hard_bc: bool = False  # lifted ansatz w = L + D * N: L the Coons interpolant of
    # the exact velocity traces, D = (bubble, bubble, 1); u and v exact on the
    # boundary, p soft (the gauge); requires bc_pressure=True
    eq_weights: Optional[Tuple[float, float, float]] = None  # per-equation residual
    # weights (x-momentum, y-momentum, continuity), inside the weak residual
    # (the loss and the GN residual vector see them alike)
    bc_pressure: bool = True  # prescribe p on the boundary beside (u, v); False:
    # velocity-only Dirichlet data and a one-point pressure anchor
    p_anchor_weight: float = 10.0  # weight of the pressure anchor (bc_pressure=False)
    inverse: bool = False  # trainable viscosity nu = params["pde"]["nu"], from
    # interior velocity sensors
    nu_init: float = 0.1  # inverse-mode initial viscosity
    n_sensors: int = 64  # interior (u, v) sensors (inverse mode; LHS-sampled)
    sensor_noise: float = 0.0  # additive N(0, noise^2) on sensor readings
    domain_x: Tuple[float, float] = (-0.5, 1.0)
    domain_y: Tuple[float, float] = (-0.5, 1.5)
    dtype: str = "float32"
    deriv_mode: str = "jvp"  # vector ansatz: the JVP engine (the build does not read it)
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=5000, check_every=100)
    )


@dataclass(frozen=True)
class TaylorGreenConfig:
    """Unsteady incompressible Navier-Stokes, the Taylor-Green vortex
    (nu = 1/Re):

        w_t + (w . grad) w + grad p = nu Lap w,   div w = 0,   w = (u, v)

    on [x_l, x_r] x [y_l, y_r] x [t_start, T], with the exact decaying vortex

        u = -cos(x) sin(y) e^{-2 nu t},  v = sin(x) cos(y) e^{-2 nu t}
        p = -(cos(2x) + cos(2y))/4 e^{-4 nu t}.

    A time-dependent system: an (x, y, t) -> (u, v, p) ansatz against the
    stacked weak residual on the space-time tensor machinery
    (ops/assembly.py::ns_unsteady_residual; time the slowest axis)."""

    layers: Tuple[int, ...] = (3, 30, 30, 30, 3)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 (models/mlp.py)
    var_form: int = 1  # 0 | 1 (once-IBP diffusion + pressure, in space)
    hard_bc: bool = False  # lifted ansatz: the velocity exact on the side walls and
    # the t = t_start face (the space-time Coons interpolant); requires bc_pressure=True
    re: float = 10.0  # Reynolds number; nu = 1/re
    n_elements_x: int = 2
    n_elements_y: int = 2
    n_elements_t: int = 2
    grid_x: Optional[Tuple[float, ...]] = None
    grid_y: Optional[Tuple[float, ...]] = None
    grid_t: Optional[Tuple[float, ...]] = None
    n_test_x: int = 6
    n_test_y: int = 6
    n_test_t: int = 6
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 10
    n_bound: int = 60  # LHS points per face (4 side walls + the t = t_start face)
    lossb_weight: float = 10.0
    eq_weights: Optional[Tuple[float, float, float]] = None  # per-equation residual
    # weights, as KovasznayConfig.eq_weights
    bc_pressure: bool = True  # prescribe p on the side walls beside (u, v); False:
    # velocity-only walls and a pressure anchor curve (one point, n_anchor times)
    p_anchor_weight: float = 10.0
    n_anchor: int = 16  # anchor times (bc_pressure=False only)
    p_zero_mean_weight: float = 0.0  # > 0 adds the zero-mean-per-time-slice gauge
    # penalty: p's spatial quadrature mean pinned to the exact slice mean at
    # n_zero_mean_t times
    n_zero_mean_t: int = 16  # time slices of the zero-mean penalty
    p_test_enrich: int = 0  # extra tensor test modes for the momentum rows only;
    # continuity keeps the base orders by an equation-selective mask, and its
    # masked rows still count in the per-element n_test normalizer
    inverse: bool = False  # trainable viscosity nu = params["pde"]["nu"]
    nu_init: float = 0.3  # inverse-mode initial viscosity
    n_sensors: int = 96  # interior space-time (u, v) sensors (inverse mode)
    sensor_noise: float = 0.0
    domain_x: Tuple[float, float] = (0.0, math.pi)
    domain_y: Tuple[float, float] = (0.0, math.pi)
    t_final: float = 1.0
    t_start: float = 0.0  # time-slab lower edge: the initial face is at t_start
    # (exact vortex values, or build(..., ic_fn=))
    dtype: str = "float32"
    deriv_mode: str = "jvp"  # vector ansatz: the JVP engine (the build does not read it)
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=5000, check_every=100)
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


def poisson1d_precision() -> Poisson1DConfig:
    """The quality hp grid with the test space raised to p = 50, float64,
    Adam 1000 and a 200-step Gauss-Newton/LM phase (the JAX package's
    rel-L2 1.09e-4)."""
    return replace(
        poisson1d_quality(),
        dtype="float64",
        n_test=50,
        train=TrainConfig(iterations=1000, gn_iterations=200, check_every=200),
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


def poisson2d_precision(hard_bc: bool = True) -> Poisson2DConfig:
    """The quality configuration (hard BC by default) plus a 50-step LM
    phase; in float32 its damped step is the float64 "host" solve (on the
    card here).  The JAX package's rel-L2: 7.3e-5 hard BC."""
    base = poisson2d_quality(hard_bc=hard_bc)
    return replace(base, train=replace(base.train, gn_iterations=50))


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
    phase after Adam 1500 (float64)."""
    return AdvDiffConfig(
        dtype="float64",
        train=TrainConfig(iterations=1500, gn_iterations=150, check_every=300),
    )


def advdiff_forward_precision() -> AdvDiffConfig:
    """The forward frontier: the outflow-layer input feature, a
    front-clustered x-grid and a 150-step QR-LM phase."""
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


def helmholtz2d_quality() -> Helmholtz2DConfig:
    """A sin net, the hard-BC Coons trace lift, Adam 5k + L-BFGS 5k and a
    10-step QR-LM tail."""
    return Helmholtz2DConfig(
        activation="sin",
        hard_bc=True,
        train=TrainConfig(iterations=5000, lbfgs_iterations=5000,
                          gn_iterations=10, gn_solve="qr", check_every=1000),
    )


def helmholtz2d_precision() -> Helmholtz2DConfig:
    """The quality point at Adam 10k + L-BFGS 10k and a 50-step QR-LM phase."""
    base = helmholtz2d_quality()
    return replace(
        base,
        hard_bc=True,
        train=replace(base.train, iterations=10000, lbfgs_iterations=10000,
                      gn_iterations=50, gn_solve="qr"),
    )


def burgers_quality() -> BurgersConfig:
    """The hard-BC lifted ansatz, a front-clustered 5-element x-grid,
    10 x 8 test functions, 20-point quadrature, Adam 10k + L-BFGS 20k."""
    return BurgersConfig(
        grid_x=(-1.0, -0.3, -0.08, 0.08, 0.3, 1.0),
        n_test_x=10,
        n_quad=20,
        hard_bc=True,
        train=TrainConfig(iterations=10000, lbfgs_iterations=20000, check_every=1000),
    )


def burgers_precision() -> BurgersConfig:
    """The quality point with a 40-step QR-LM phase."""
    base = burgers_quality()
    return replace(base, train=replace(base.train, gn_iterations=40, gn_solve="qr"))


def poisson3d_quality(hard_bc: bool = False) -> Poisson3DConfig:
    """(3,48,48,48,1) net, 6^3 test functions, 10^3 quadrature points, 8
    elements, Adam 10k + L-BFGS 10k; hard_bc=True lifts the ansatz (all six
    faces exact)."""
    return Poisson3DConfig(
        layers=(3, 48, 48, 48, 1),
        n_test_x=6,
        n_test_y=6,
        n_test_z=6,
        n_quad=10,
        hard_bc=hard_bc,
        train=TrainConfig(iterations=10000, lbfgs_iterations=10000, check_every=1000),
    )


def poisson3d_precision(hard_bc: bool = True) -> Poisson3DConfig:
    """The quality point with 8^3 test functions and a 30-step matrix-free
    (CG) Gauss-Newton/LM phase.  Its default hard BC runs on "jvp"; under
    "pallas" the matrix-free CG raises (the kernels have no JVP)."""
    base = poisson3d_quality(hard_bc=hard_bc)
    return replace(
        base,
        n_test_x=8, n_test_y=8, n_test_z=8,
        train=replace(base.train, gn_iterations=30, gn_solve="cg",
                      gn_cg_tol=1e-4, gn_cg_maxiter=2000),
    )


def advdiff2d_precision() -> AdvDiff2DConfig:
    """The forward frontier of the 2D space-time family: eps frozen at truth,
    a (3,32,32,32,1) net, 8^3 test functions, 10^3 quadrature points, Adam
    5000 and a 120-step QR-LM phase."""
    return AdvDiff2DConfig(
        layers=(3, 32, 32, 32, 1),
        n_test_x=8,
        n_test_y=8,
        n_test_t=8,
        n_quad=10,
        inverse=False,
        train=TrainConfig(
            iterations=5000,
            gn_iterations=120,
            gn_solve="qr",
            check_every=500,
            best_snapshot_fraction=0.9,
        ),
    )


def kovasznay_quality() -> KovasznayConfig:
    """The default 2x2 mesh, 8x8 test functions and (2,30,30,30,3) net at
    Adam 10k + L-BFGS 10k."""
    return KovasznayConfig(
        train=TrainConfig(iterations=10000, lbfgs_iterations=10000, check_every=1000),
    )


def kovasznay_precision() -> KovasznayConfig:
    """The hard-BC lifted ansatz, a 3x3 mesh, a (2,50,50,50,3) net, Adam 10k
    + L-BFGS 10k and a 250-step QR-LM phase."""
    return KovasznayConfig(
        layers=(2, 50, 50, 50, 3),
        n_elements_x=3,
        n_elements_y=3,
        hard_bc=True,
        train=TrainConfig(
            iterations=10000,
            lbfgs_iterations=10000,
            gn_iterations=250,
            gn_solve="qr",
            check_every=1000,
        ),
    )


def taylorgreen_quality() -> TaylorGreenConfig:
    """The default 2x2x2 space-time mesh, 6^3 test functions and
    (3,30,30,30,3) net at Adam 10k + L-BFGS 10k."""
    return TaylorGreenConfig(
        train=TrainConfig(iterations=10000, lbfgs_iterations=10000, check_every=1000),
    )


def taylorgreen_precision() -> TaylorGreenConfig:
    """The space-time hard-BC lift, a 3x3x2 mesh, 6^3 test functions, a
    (3,50,50,50,3) net, var_form 0, the zero-mean-per-time-slice pressure
    gauge at weight 10, Adam 10k + L-BFGS 10k and a 250-step QR-LM phase."""
    return TaylorGreenConfig(
        layers=(3, 50, 50, 50, 3),
        n_elements_x=3,
        n_elements_y=3,
        var_form=0,
        hard_bc=True,
        p_zero_mean_weight=10.0,
        train=TrainConfig(
            iterations=10000,
            lbfgs_iterations=10000,
            gn_iterations=250,
            gn_solve="qr",
            check_every=1000,
        ),
    )


__all__ = [
    "AdvDiff2DConfig",
    "AdvDiffConfig",
    "BurgersConfig",
    "Helmholtz2DConfig",
    "KovasznayConfig",
    "TaylorGreenConfig",
    "TrainConfig",
    "Poisson1DConfig",
    "Poisson2DConfig",
    "Poisson3DConfig",
    "advdiff2d_precision",
    "advdiff_forward_precision",
    "advdiff_of_record",
    "advdiff_precision",
    "advdiff_quality",
    "burgers_precision",
    "burgers_quality",
    "helmholtz2d_precision",
    "helmholtz2d_quality",
    "kovasznay_precision",
    "kovasznay_quality",
    "poisson1d_of_record",
    "poisson1d_precision",
    "poisson1d_quality",
    "poisson2d_of_record",
    "poisson2d_precision",
    "poisson2d_quality",
    "poisson2d_scaled",
    "poisson3d_precision",
    "poisson3d_quality",
    "replace",
    "taylorgreen_precision",
    "taylorgreen_quality",
]
