"""Parameter conversion between the JAX package's pytree and the port.

The JAX params are {"net": [{"W": [in, out], "b": [out]}, ...], "pde": {...}};
the port keeps the same structure and the same [in, out] layout with
`nn.Parameter` leaves.  The JAX side hands its arrays over as numpy (e.g.
`jax.tree.map(np.asarray, params)`), so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_jax(tree, device=None, dtype=torch.float32):
    """JAX params pytree of numpy arrays -> the port's params on `device`."""

    def leaf(a):
        return nn.Parameter(torch.tensor(np.asarray(a)).to(device=device, dtype=dtype))

    return {
        "net": [{"W": leaf(layer["W"]), "b": leaf(layer["b"])} for layer in tree["net"]],
        "pde": {k: leaf(v) for k, v in tree.get("pde", {}).items()},
    }


def params_to_numpy(params):
    """The inverse: the port's params -> a JAX-shaped pytree of numpy arrays."""

    def leaf(t):
        return t.detach().cpu().numpy()

    return {
        "net": [{"W": leaf(layer["W"]), "b": leaf(layer["b"])} for layer in params["net"]],
        "pde": {k: leaf(v) for k, v in params["pde"].items()},
    }
