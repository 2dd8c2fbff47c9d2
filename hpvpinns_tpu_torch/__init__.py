"""hp-VPINNs in PyTorch for NVIDIA Hopper: the port of `hpvpinns_tpu`.

The JAX package `hpvpinns_tpu` is the reference; this package follows its
layout and names module for module, and never imports JAX or it.  The
ported slice is the Poisson-1D (forms 1/2/3, hard BC), Poisson-2D (forms
0/1/2/"2c", hard BC, the PINN scheme), Poisson-3D (forms 0/1, hard BC),
Helmholtz-2D (forms 0/1, hard BC, k^2 identification), AdvDiff
identification (forms 0/1/2, scalar/quadratic/network eps, trainable
velocity, hard BC), AdvDiff-2D identification (forms 0/1, eps and the
velocity vector), Burgers (forms 0/1, hard BC, the front feature, strong
collocation) and the Navier-Stokes systems Kovasznay and Taylor-Green (forms
0/1, hard BC, viscosity identification, the pressure gauges) problems with the Adam, L-BFGS (optax's) and Gauss-Newton/LM
trainer, checkpoints (training/checkpoint.py) and the float64 polish
(training/hybrid.py), the seed ensemble (training/ensemble.py), slab
time marching (training/timemarch.py), and the coefficient-identification
suite: the two-phase field fits, ALS and the network-free reduced routes
(inverse.py) with their error bars (uncertainty.py), whose torch work runs
on the problem's device.  Their derivative fields come from the
plain Taylor propagation ("taylor"), the JVP engine ("jvp", ops/fields.py)
or the hand-written CUDA kernels csrc/fused_fields.cu (forward, B1) and
csrc/fused_fields_bwd.cu (second-derivative backward, B2) under
deriv_mode="pallas" (ops/fused_fields.py).  Problems are built on the card
unless the caller passes device="cpu".  ROADMAP.md lists what is still to
port.
"""

from hpvpinns_tpu_torch.config import (
    AdvDiff2DConfig,
    AdvDiffConfig,
    BurgersConfig,
    Helmholtz2DConfig,
    KovasznayConfig,
    Poisson1DConfig,
    Poisson2DConfig,
    Poisson3DConfig,
    TaylorGreenConfig,
    TrainConfig,
    advdiff2d_precision,
    advdiff_forward_precision,
    advdiff_of_record,
    advdiff_precision,
    advdiff_quality,
    burgers_precision,
    burgers_quality,
    helmholtz2d_precision,
    helmholtz2d_quality,
    kovasznay_precision,
    kovasznay_quality,
    poisson1d_of_record,
    poisson1d_precision,
    poisson1d_quality,
    poisson2d_of_record,
    poisson2d_precision,
    poisson2d_quality,
    poisson2d_scaled,
    poisson3d_precision,
    poisson3d_quality,
    taylorgreen_precision,
    taylorgreen_quality,
)
from hpvpinns_tpu_torch import inverse, uncertainty  # noqa: F401  (tv.inverse, tv.uncertainty)
from hpvpinns_tpu_torch.convert import params_from_jax, params_to_numpy
from hpvpinns_tpu_torch.evaluate import evaluate as evaluate_problem
from hpvpinns_tpu_torch.evaluate import per_element_rel_l2, predict, rel_l2, strong_residual
from hpvpinns_tpu_torch.problems import build
from hpvpinns_tpu_torch.training import (
    EnsembleResult,
    GNResult,
    TimeMarchResult,
    TrainResult,
    gauss_newton,
    time_march,
    train,
    train_ensemble,
)

__version__ = "0.1.0"

__all__ = [
    "AdvDiff2DConfig",
    "AdvDiffConfig",
    "BurgersConfig",
    "EnsembleResult",
    "Helmholtz2DConfig",
    "KovasznayConfig",
    "Poisson1DConfig",
    "Poisson2DConfig",
    "Poisson3DConfig",
    "GNResult",
    "TaylorGreenConfig",
    "TimeMarchResult",
    "TrainConfig",
    "TrainResult",
    "advdiff2d_precision",
    "advdiff_forward_precision",
    "advdiff_of_record",
    "advdiff_precision",
    "advdiff_quality",
    "build",
    "burgers_precision",
    "burgers_quality",
    "evaluate_problem",
    "gauss_newton",
    "helmholtz2d_precision",
    "helmholtz2d_quality",
    "kovasznay_precision",
    "kovasznay_quality",
    "params_from_jax",
    "per_element_rel_l2",
    "params_to_numpy",
    "poisson1d_of_record",
    "poisson1d_precision",
    "poisson1d_quality",
    "poisson2d_of_record",
    "poisson2d_precision",
    "poisson2d_quality",
    "poisson2d_scaled",
    "poisson3d_precision",
    "poisson3d_quality",
    "predict",
    "rel_l2",
    "strong_residual",
    "taylorgreen_precision",
    "taylorgreen_quality",
    "time_march",
    "train",
    "train_ensemble",
]
