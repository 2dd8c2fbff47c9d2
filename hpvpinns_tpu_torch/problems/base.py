"""Problem bundle: everything the generic trainer needs.

Counterpart of hpvpinns_tpu/problems/base.py.  A problem module's
`build(config)` returns a `Problem`: static spec + device-ready data + loss
and apply functions.  Parameters follow the JAX package's convention

    params = {"net": [{"W": [in, out], "b": [out]}, ...], "pde": {...}}

with `nn.Parameter` leaves; `pde` (trainable PDE coefficients) is empty for
forward problems.  A `pde` value is one tensor (a coefficient or a
coefficient vector) or a network, a list of {"W", "b"} layers (AdvDiff's
neural eps(x) field, "eps_net").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp, mlp_apply

# Every family's cfg.dtype, as JAX builds it with jnp.dtype(cfg.dtype): the
# host build stays float64 and is cast to this at the end.  The kernels of
# deriv_mode="pallas" take float32 only (ops/fused_fields.py).
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


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
    apply_override: Optional[Callable] = None  # (params, X) -> u, for
    # composite ansatzes (e.g. hard-BC lifting u = g + D * N)

    def apply(self, params, X: torch.Tensor) -> torch.Tensor:
        """Solution ansatz at points X: [P, d_in] -> [P, 1]."""
        if self.apply_override is not None:
            return self.apply_override(params, X)
        return mlp_apply(self.spec, params["net"], X)


def resolve_device(device) -> torch.device:
    """The device a problem is built on: `device` when given, else the card
    (torch.device("cuda")).  With no CUDA device and no `device` it raises;
    it never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: problems are built on the GPU by default; "
            "pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda")


def make_composite_apply(spec: MLP, lift: Callable, envelope: Callable, feature_fn: Optional[Callable] = None):
    """Hard-BC ansatz factory: u(params, X) = lift(X) + envelope(X) * N(X).

    The envelope vanishes on the boundary and the lift interpolates the
    Dirichlet data there, so the BC holds exactly for any parameters.  An
    optional `feature_fn(X) -> [P, m]` augments the network input
    (N([X, feature(X)])), as make_feature_apply does."""

    def u_of(params):
        def apply(X):
            Xf = X if feature_fn is None else torch.cat([X, feature_fn(X)], dim=-1)
            return lift(X) + envelope(X) * mlp_apply(spec, params["net"], Xf)

        return apply

    return u_of


def make_feature_apply(spec: MLP, feature_fn: Callable):
    """Input-feature ansatz factory: u(params, X) = N([X, feature(X)]).

    `feature_fn` maps [P, d] points to [P, m] extra input columns, in torch
    operations, so the JVP engine (ops/fields.py) differentiates it exactly.
    The spec's first layer width must be d + m."""

    def u_of(params):
        def apply(X):
            return mlp_apply(spec, params["net"], torch.cat([X, feature_fn(X)], dim=-1))

        return apply

    return u_of


def make_net_init(spec: MLP, pde_init: Optional[Callable] = None, dtype=torch.float32, device=None):
    """init_params factory: Xavier net (drawn from a CPU torch.Generator,
    then moved to `device`) and the PDE coefficients `pde_init()` (none when
    it is None)."""

    def init(generator: torch.Generator):
        params = {"net": init_mlp(spec, generator, dtype=dtype, device=device), "pde": {}}
        if pde_init is not None:
            params["pde"] = pde_init()
        return params

    return init


def _layer_leaves(layers):
    """A network's leaves layer by layer: W, b, then the adaptive slope s
    where the layer has one (the JAX package's sorted-key order)."""
    return [layer[k] for layer in layers for k in ("W", "b", "s") if k in layer]


def _pde_leaves(value):
    if isinstance(value, (list, tuple)):  # a network
        return _layer_leaves(value)
    return [value]


def parameters(params):
    """Every trainable leaf once, in a fixed order (JAX's tree-leaf order):
    the net layer by layer (W, b, and s with an adaptive slope), then the
    pde values by sorted name, a network value layer by layer."""
    leaves = _layer_leaves(params["net"])
    return leaves + [t for k in sorted(params["pde"]) for t in _pde_leaves(params["pde"][k])]


def map_params(fn: Callable, params):
    """A params tree of the same nesting with fn(leaf) at every leaf: the
    net's layers, and each pde value (a tensor, or a network of layers)."""

    def net(layers):
        return [{k: fn(v) for k, v in layer.items()} for layer in layers]

    return {
        "net": net(params["net"]),
        "pde": {k: net(v) if isinstance(v, (list, tuple)) else fn(v) for k, v in params.get("pde", {}).items()},
    }
