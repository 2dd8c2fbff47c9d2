"""Dense MLP ansatz network.

Counterpart of hpvpinns_tpu/models/mlp.py.  Parameters are a list of layers
{"W": [in, out], "b": [out]} of `nn.Parameter`s; W keeps the JAX package's
[in, out] layout (`x @ W`, not nn.Linear's [out, in]), so the converter, the
plain versions and the fused kernel all read one layout.  Xavier
truncated-normal init (std = sqrt(2/(fan_in+fan_out)), truncated at ±2 std),
zero biases, a sin, tanh, gelu (the tanh form, jax.nn.gelu's default) or
swish hidden activation, linear output layer.

`adaptive_slope=True` adds a trainable slope "s" = 1 to every hidden layer,
applied as act(s z) (JAX mlp.py:72-74,85-86); the leaves of a layer are then
W, b, s, the JAX package's leaf order.

`precision` is the JAX package's matmul precision of the network's products
(`mlp_apply` and the Taylor propagation, ops/taylor.py), and of nothing
else: the contractions and the CUDA kernels stay IEEE fp32.  "highest" is
IEEE fp32 (TF32 off, the process-wide default that `use_ieee_fp32_matmuls`
sets); "high" and "default" are TF32 on the card, as JAX maps them for f32
on a GPU.  Their products go through `network_matmul`, an autograd.Function
that turns TF32 on around its own GEMMs only, in its forward, its backward
and its forward-mode rule, and restores the flag after them.  A TF32 GEMM
captured in a CUDA graph stays TF32 on replay.  On the CPU there is no TF32:
"high" and "default" give what "highest" gives, as JAX on the CPU does.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "sin": torch.sin,
    "tanh": torch.tanh,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),  # jax.nn.gelu's default, approximate=True
    # swish as z * sigmoid(z), not F.silu: silu's forward-mode rule goes
    # through aten::silu_backward, which has none of its own, so a nested
    # JVP (a second derivative) through it raises with grad mode off.
    "swish": lambda z: z * torch.sigmoid(z),
}
PRECISIONS = ("highest", "high", "default")


@dataclass(frozen=True)
class MLP:
    """Static network spec."""

    layers: tuple
    activation: str = "tanh"
    precision: str = "highest"  # "highest" = IEEE fp32; "high"/"default" = TF32 on the card
    adaptive_slope: bool = False  # trainable per-layer activation slope s_l: act(s_l z)

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(int(w) for w in self.layers))
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown matmul precision {self.precision!r}; expected one of {PRECISIONS}")

    @property
    def n_layers(self) -> int:
        return len(self.layers) - 1


def use_ieee_fp32_matmuls() -> None:
    """The process-wide default, matmul_precision="highest": full fp32
    products in cuBLAS and cuDNN.  The network's "high"/"default" products
    turn TF32 on for themselves (`network_matmul`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def _tf32_matmuls():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _TF32Matmul(torch.autograd.Function):
    """A @ W with TF32 on for this GEMM only; its backward's and its JVP's
    GEMMs are again this function, so every order of derivative stays TF32.
    The vmap rule is generated (the forward is one matmul)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, W):
        with _tf32_matmuls():
            return A @ W

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)
        # An input without a tangent comes to `jvp` as None: torch.func's
        # materialized zero tangents lose the outer level of a nested JVP.
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        A, W = ctx.saved_tensors
        gA = _TF32Matmul.apply(g, W.mT) if ctx.needs_input_grad[0] else None
        gW = _TF32Matmul.apply(A.mT, g) if ctx.needs_input_grad[1] else None
        return gA, gW

    @staticmethod
    def jvp(ctx, tA, tW):
        A, W = ctx.saved_tensors
        parts = ([_TF32Matmul.apply(tA, W)] if tA is not None else []) + (
            [_TF32Matmul.apply(A, tW)] if tW is not None else [])
        return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def network_matmul(spec: MLP):
    """The network's product A @ W [in, out] at spec.precision: torch.matmul
    for "highest", the TF32 function for "high" and "default"."""
    return torch.matmul if spec.precision == "highest" else _TF32Matmul.apply


def init_mlp(spec: MLP, generator: torch.Generator, dtype=torch.float32, device=None):
    """Xavier truncated-normal weights (bounds ±2 std, absolute as torch's
    trunc_normal_ takes them), zero biases, and with adaptive_slope a slope
    s = 1 on every hidden layer.  The weights are drawn on the host from the
    CPU `generator` and then moved to `device`, so one seed gives the same
    network on every device."""
    params = []
    for l in range(spec.n_layers):
        fan_in, fan_out = spec.layers[l], spec.layers[l + 1]
        std = math.sqrt(2.0 / (fan_in + fan_out))
        W = torch.empty((fan_in, fan_out), dtype=dtype)
        nn.init.trunc_normal_(W, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        b = torch.zeros((fan_out,), dtype=dtype)
        layer = {"W": nn.Parameter(W.to(device)), "b": nn.Parameter(b.to(device))}
        if spec.adaptive_slope and l < spec.n_layers - 1:
            layer["s"] = nn.Parameter(torch.ones((), dtype=dtype, device=device))
        params.append(layer)
    return params


def mlp_apply(spec: MLP, params, X: torch.Tensor) -> torch.Tensor:
    """Forward pass on a batch of points X: [P, d_in] -> [P, d_out]."""
    act = _ACTIVATIONS[spec.activation]
    dot = network_matmul(spec)
    H = X
    for layer in params[:-1]:
        z = dot(H, layer["W"]) + layer["b"]
        if "s" in layer:
            z = layer["s"] * z
        H = act(z)
    last = params[-1]
    return dot(H, last["W"]) + last["b"]
