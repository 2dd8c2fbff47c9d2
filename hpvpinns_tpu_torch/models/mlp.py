"""Dense MLP ansatz network.

Counterpart of hpvpinns_tpu/models/mlp.py.  Parameters are a list of layers
{"W": [in, out], "b": [out]} of `nn.Parameter`s; W keeps the JAX package's
[in, out] layout (`x @ W`, not nn.Linear's [out, in]), so the converter, the
plain versions and the fused kernel all read one layout.  Xavier
truncated-normal init (std = sqrt(2/(fan_in+fan_out)), truncated at ±2 std),
zero biases, sin or tanh hidden activation, linear output layer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

_ACTIVATIONS = {"sin": torch.sin, "tanh": torch.tanh}


@dataclass(frozen=True)
class MLP:
    """Static network spec."""

    layers: tuple
    activation: str = "tanh"
    precision: str = "highest"  # "highest" = IEEE fp32 matmuls (TF32 off)
    adaptive_slope: bool = False

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(int(w) for w in self.layers))
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"activation {self.activation!r} is not ported (sin, tanh)")
        if self.precision != "highest":
            raise NotImplementedError(
                f"matmul_precision={self.precision!r} is not ported yet (ROADMAP.md); "
                "'highest' (IEEE fp32, TF32 off) is"
            )
        if self.adaptive_slope:
            raise NotImplementedError("adaptive_slope is not ported yet (ROADMAP.md)")

    @property
    def n_layers(self) -> int:
        return len(self.layers) - 1


def use_ieee_fp32_matmuls() -> None:
    """matmul_precision="highest": full fp32 products in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_mlp(spec: MLP, generator: torch.Generator, dtype=torch.float32, device=None):
    """Xavier truncated-normal weights (bounds ±2 std, absolute as torch's
    trunc_normal_ takes them) and zero biases.  The weights are drawn on the
    host from the CPU `generator` and then moved to `device`, so one seed
    gives the same network on every device."""
    params = []
    for l in range(spec.n_layers):
        fan_in, fan_out = spec.layers[l], spec.layers[l + 1]
        std = math.sqrt(2.0 / (fan_in + fan_out))
        W = torch.empty((fan_in, fan_out), dtype=dtype)
        nn.init.trunc_normal_(W, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        b = torch.zeros((fan_out,), dtype=dtype)
        params.append({"W": nn.Parameter(W.to(device)), "b": nn.Parameter(b.to(device))})
    return params


def mlp_apply(spec: MLP, params, X: torch.Tensor) -> torch.Tensor:
    """Forward pass on a batch of points X: [P, d_in] -> [P, d_out]."""
    act = _ACTIVATIONS[spec.activation]
    H = X
    for layer in params[:-1]:
        H = act(H @ layer["W"] + layer["b"])
    last = params[-1]
    return H @ last["W"] + last["b"]
