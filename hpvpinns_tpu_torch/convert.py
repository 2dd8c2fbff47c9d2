"""Parameter conversion between the JAX package's pytree and the port.

The JAX params are {"net": [{"W": [in, out], "b": [out]}, ...], "pde": {...}},
where a pde value is an array or a network of {"W", "b"} layers (AdvDiff's
"eps_net"); the port keeps the same nesting and the same [in, out] layout
with `nn.Parameter` leaves.  The JAX side hands its arrays over as numpy
(e.g. `jax.tree.map(np.asarray, params)`), so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.problems.base import map_params


def params_from_jax(tree, device=None, dtype=torch.float32):
    """JAX params pytree of numpy arrays -> the port's params on `device`."""
    return map_params(lambda a: nn.Parameter(torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)), tree)


def params_to_numpy(params):
    """The inverse: the port's params -> a JAX-shaped pytree of numpy arrays."""
    return map_params(lambda t: t.detach().cpu().numpy(), params)
