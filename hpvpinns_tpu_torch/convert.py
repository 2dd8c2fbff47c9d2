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


def flatten_tree(tree) -> dict:
    """A JAX-shaped params tree of arrays -> {path: numpy array}, the path
    "net/<i>/<W|b>", "pde/<name>" or "pde/<name>/<i>/<W|b>" (a pde network):
    the keys of a saved draw (`np.savez`), from which `unflatten_tree`
    rebuilds the nesting."""
    flat = {}
    for i, layer in enumerate(tree["net"]):
        flat.update({f"net/{i}/{k}": np.asarray(v) for k, v in layer.items()})
    for name, v in tree.get("pde", {}).items():
        if isinstance(v, (list, tuple)):
            for i, layer in enumerate(v):
                flat.update({f"pde/{name}/{i}/{k}": np.asarray(a) for k, a in layer.items()})
        else:
            flat[f"pde/{name}"] = np.asarray(v)
    return flat


def unflatten_tree(flat) -> dict:
    """The inverse of `flatten_tree`: {path: array} -> the params tree of
    numpy arrays that `params_from_jax` takes."""
    tree = {"net": [], "pde": {}}

    def put(layers, i, k, a):
        layers.extend({} for _ in range(int(i) + 1 - len(layers)))
        layers[int(i)][k] = np.asarray(a)

    for path, a in flat.items():
        parts = path.split("/")
        if parts[0] == "net" and len(parts) == 3:
            put(tree["net"], parts[1], parts[2], a)
        elif parts[0] == "pde" and len(parts) == 2:
            tree["pde"][parts[1]] = np.asarray(a)
        elif parts[0] == "pde" and len(parts) == 4:
            put(tree["pde"].setdefault(parts[1], []), parts[2], parts[3], a)
        else:
            raise ValueError(f"not a params path: {path!r}")
    return tree


def load_draw(path: str, device=None, dtype=torch.float32):
    """A saved draw (an `.npz` of `flatten_tree`'s keys) -> the port's params
    on `device` in `dtype`."""
    with np.load(path) as f:
        return params_from_jax(unflatten_tree(dict(f)), device=device, dtype=dtype)
