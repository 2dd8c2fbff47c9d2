"""hp-VPINNs in PyTorch for NVIDIA Hopper: the port of `hpvpinns_tpu`.

The JAX package `hpvpinns_tpu` is the reference; this package follows its
layout and names module for module, and never imports JAX or it.  The
ported slice is the Poisson-1D (forms 1/2/3, hard BC), Poisson-2D (forms
0/1/2/"2c", hard BC, the PINN scheme) and AdvDiff identification (forms
0/1/2, scalar/quadratic/network eps, trainable velocity, hard BC) problems
with the Adam and L-BFGS trainer.  Their derivative fields come from the
plain Taylor propagation ("taylor"), the JVP engine ("jvp", ops/fields.py)
or the hand-written CUDA kernels csrc/fused_fields.cu (forward, B1) and
csrc/fused_fields_bwd.cu (second-derivative backward, B2) under
deriv_mode="pallas" (ops/fused_fields.py).  Problems are built on the card
unless the caller passes device="cpu".  ROADMAP.md lists what is still to
port.
"""

from hpvpinns_tpu_torch.config import (
    AdvDiffConfig,
    Poisson1DConfig,
    Poisson2DConfig,
    TrainConfig,
    advdiff_forward_precision,
    advdiff_of_record,
    advdiff_precision,
    advdiff_quality,
    poisson1d_of_record,
    poisson1d_quality,
    poisson2d_of_record,
    poisson2d_quality,
    poisson2d_scaled,
)
from hpvpinns_tpu_torch.convert import params_from_jax, params_to_numpy
from hpvpinns_tpu_torch.evaluate import evaluate as evaluate_problem
from hpvpinns_tpu_torch.evaluate import predict, rel_l2, strong_residual
from hpvpinns_tpu_torch.problems import build
from hpvpinns_tpu_torch.training import TrainResult, train

__all__ = [
    "AdvDiffConfig",
    "Poisson1DConfig",
    "Poisson2DConfig",
    "TrainConfig",
    "TrainResult",
    "advdiff_forward_precision",
    "advdiff_of_record",
    "advdiff_precision",
    "advdiff_quality",
    "build",
    "evaluate_problem",
    "params_from_jax",
    "params_to_numpy",
    "poisson1d_of_record",
    "poisson1d_quality",
    "poisson2d_of_record",
    "poisson2d_quality",
    "poisson2d_scaled",
    "predict",
    "rel_l2",
    "strong_residual",
    "train",
]
