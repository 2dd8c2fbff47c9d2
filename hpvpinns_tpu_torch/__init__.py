"""hp-VPINNs in PyTorch for NVIDIA Hopper: the port of `hpvpinns_tpu`.

The JAX package `hpvpinns_tpu` is the reference; this package follows its
layout and names module for module, and never imports JAX or it.  The
ported slice is the Poisson-1D (forms 1/2/3) and Poisson-2D (forms
0/1/2/"2c") hp-VPINN trainers with Adam, whose derivative fields run in the
hand-written CUDA kernels csrc/fused_fields.cu (forward, B1) and
csrc/fused_fields_bwd.cu (second-derivative backward, B2) under
deriv_mode="pallas" (ops/fused_fields.py).  Problems are built on the card
unless the caller passes device="cpu".  ROADMAP.md lists what is still to
port.
"""

from hpvpinns_tpu_torch.config import (
    Poisson1DConfig,
    Poisson2DConfig,
    TrainConfig,
    poisson1d_of_record,
    poisson1d_quality,
    poisson2d_of_record,
    poisson2d_quality,
    poisson2d_scaled,
)
from hpvpinns_tpu_torch.convert import params_from_jax, params_to_numpy
from hpvpinns_tpu_torch.evaluate import evaluate as evaluate_problem
from hpvpinns_tpu_torch.evaluate import predict, rel_l2
from hpvpinns_tpu_torch.problems import build
from hpvpinns_tpu_torch.training import TrainResult, train

__all__ = [
    "Poisson1DConfig",
    "Poisson2DConfig",
    "TrainConfig",
    "TrainResult",
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
    "train",
]
