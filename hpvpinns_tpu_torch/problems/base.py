"""Problem bundle: everything the generic trainer needs.

Counterpart of hpvpinns_tpu/problems/base.py.  A problem module's
`build(config)` returns a `Problem`: static spec + device-ready data + loss
and apply functions.  Parameters follow the JAX package's convention

    params = {"net": [{"W": [in, out], "b": [out]}, ...], "pde": {...}}

with `nn.Parameter` leaves; `pde` (trainable PDE coefficients) is empty for
forward problems.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp, mlp_apply


@dataclass
class Problem:
    name: str
    config: Any
    spec: MLP
    data: Any  # dict passed to loss_fn; data["elements"] has a leading element axis
    loss_fn: Callable  # (params, data) -> (loss, aux_dict)
    init_params: Callable  # (torch.Generator) -> params
    exact: Optional[Callable] = None  # vectorized exact solution
    test_points: Optional[np.ndarray] = None  # dense eval grid [P, d]
    test_values: Optional[np.ndarray] = None  # exact u at test_points [P, 1]
    extras: Dict[str, Any] = field(default_factory=dict)

    def apply(self, params, X: torch.Tensor) -> torch.Tensor:
        """Solution ansatz at points X: [P, d_in] -> [P, 1]."""
        return mlp_apply(self.spec, params["net"], X)


def make_net_init(spec: MLP, dtype=torch.float32, device=None):
    """init_params factory: Xavier net (drawn from a CPU torch.Generator,
    then moved to `device`) and no PDE coefficients."""

    def init(generator: torch.Generator):
        return {"net": init_mlp(spec, generator, dtype=dtype, device=device), "pde": {}}

    return init


def parameters(params):
    """Every trainable leaf, in a fixed order: net W_0, b_0, ..., then pde
    coefficients by name."""
    leaves = [t for layer in params["net"] for t in (layer["W"], layer["b"])]
    return leaves + [params["pde"][k] for k in sorted(params["pde"])]
