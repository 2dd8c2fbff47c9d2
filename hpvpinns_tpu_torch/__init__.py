"""hp-VPINNs in PyTorch for NVIDIA Hopper: the port of `hpvpinns_tpu`.

The JAX package `hpvpinns_tpu` is the reference; this package follows its
layout and names module for module, and never imports JAX or it.  The
ported slice is the Poisson-2D hp-VPINN trainer (var_form 1, Adam), whose
derivative fields run in the hand-written CUDA kernel
csrc/fused_fields.cu under deriv_mode="pallas" (ops/fused_fields.py).
ROADMAP.md lists what is still to port.
"""

from hpvpinns_tpu_torch.config import (
    Poisson2DConfig,
    TrainConfig,
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
    "Poisson2DConfig",
    "TrainConfig",
    "TrainResult",
    "build",
    "evaluate_problem",
    "params_from_jax",
    "params_to_numpy",
    "poisson2d_of_record",
    "poisson2d_quality",
    "poisson2d_scaled",
    "predict",
    "rel_l2",
    "train",
]
