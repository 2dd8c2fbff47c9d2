"""Fused Taylor-mode derivative propagation through the MLP (plain PyTorch).

Counterpart of hpvpinns_tpu/ops/taylor.py, with the same closed forms.  Per
layer, with z = h W + b (W constant w.r.t. x):

    z_k  = h_k W            a_k  = act'(z) z_k
    z_kk = h_kk W           a_kk = act''(z) z_k^2 + act'(z) z_kk

One traversal gives u and, per direction k, u_k (and u_kk when `second`).
With an adaptive slope s the activation is act(s z), so act' and act''
gain s and s^2.  The products run at the spec's matmul precision
(models/mlp.py::network_matmul).  Autograd differentiates straight through
it.  This is the port's plain version of the fused field kernel
(ops/fused_fields.py) and the oracle it is checked against.
"""

from __future__ import annotations

import math

import torch

from hpvpinns_tpu_torch.models.mlp import MLP, network_matmul

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715


def act_derivs(name: str, z):
    """(act, act', act'') for sin, tanh, gelu (the tanh form, as
    jax.nn.gelu's default; closed forms where the JAX package takes gelu's
    by autodiff) and swish (JAX taylor.py:52-57)."""
    if name == "sin":
        s, c = torch.sin(z), torch.cos(z)
        return s, c, -s
    if name == "tanh":
        t = torch.tanh(z)
        d1 = 1.0 - t * t
        return t, d1, -2.0 * t * d1
    if name == "gelu":  # 0.5 z (1 + tanh(u)), u = c (z + a z^3)
        zz = z * z
        t = torch.tanh(_GELU_C * (z + _GELU_A * zz * z))
        u1 = _GELU_C * (1.0 + 3.0 * _GELU_A * zz)
        sech2 = 1.0 - t * t
        return (0.5 * z * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * z * sech2 * u1,
                sech2 * (u1 + 0.5 * z * (6.0 * _GELU_A * _GELU_C * z - 2.0 * t * u1 * u1)))
    if name == "swish":
        s = torch.sigmoid(z)
        return z * s, s * (1.0 + z * (1.0 - s)), s * (1.0 - s) * (2.0 + z * (1.0 - 2.0 * s))
    raise ValueError(f"no closed-form derivatives for activation {name!r}")


def act_derivs3(name: str, z):
    """(act, act', act'', act''') for sin/tanh."""
    if name == "sin":
        s, c = torch.sin(z), torch.cos(z)
        return s, c, -s, -c
    if name == "tanh":
        t = torch.tanh(z)
        d1 = 1.0 - t * t
        return t, d1, -2.0 * t * d1, -2.0 * d1 * (1.0 - 3.0 * t * t)
    raise ValueError(f"no third-derivative table for activation {name!r}")


def mlp_fields(spec: MLP, params, X: torch.Tensor, directions, second: bool = True):
    """Network value + per-direction first (and optionally second)
    derivatives.

    X: [P, d] points; directions: input-coordinate indices, e.g. (0, 1).
    Returns (u [P, out], firsts, seconds): tuples of [P, out] ordered like
    `directions`; seconds is () when second=False.
    """
    dot = network_matmul(spec)
    h = X
    hk = []
    for k in directions:
        t = torch.zeros_like(X)
        t[:, k] = 1.0
        hk.append(t)
    hkk = [torch.zeros_like(X) for _ in directions] if second else []

    for layer in params[:-1]:
        W, b = layer["W"], layer["b"]
        z = dot(h, W) + b
        zk = [dot(t, W) for t in hk]
        zkk = [dot(t, W) for t in hkk]
        if "s" in layer:  # adaptive slope: act(s z) gains s and s^2 in its derivatives
            slope = layer["s"]
            a, d1, d2 = act_derivs(spec.activation, slope * z)
            d1, d2 = d1 * slope, d2 * slope * slope
        else:
            a, d1, d2 = act_derivs(spec.activation, z)
        h = a
        hkk = [d2 * t * t + d1 * s for t, s in zip(zk, zkk)]
        hk = [d1 * t for t in zk]

    W, b = params[-1]["W"], params[-1]["b"]
    u = dot(h, W) + b
    firsts = tuple(dot(t, W) for t in hk)
    seconds = tuple(dot(t, W) for t in hkk)
    return u, firsts, seconds


def taylor_fields_1d(spec: MLP, params, x):
    """(u, u_x, u_xx) at x [..., Q]."""
    shape = x.shape
    u, (ux,), (uxx,) = mlp_fields(spec, params, x.reshape(-1, 1), (0,))
    return u.reshape(shape), ux.reshape(shape), uxx.reshape(shape)


def taylor_fields_2d(
    spec: MLP, params, x, y, *,
    second_y: bool = True, first_y_only: bool = False, firsts_only: bool = False,
):
    """Fields of the 2D ansatz at x, y (same shape): {u, ux, uy} when
    firsts_only, else {u, ux, uxx} plus uy (first_y_only or second_y) and uyy
    (second_y and not first_y_only)."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)
    if firsts_only:
        u, (ux, uy), _ = mlp_fields(spec, params, X, (0, 1), second=False)
        return {"u": u.reshape(shape), "ux": ux.reshape(shape), "uy": uy.reshape(shape)}
    if first_y_only or second_y:
        u, (ux, uy), (uxx, uyy) = mlp_fields(spec, params, X, (0, 1))
        out = {"u": u.reshape(shape), "ux": ux.reshape(shape), "uxx": uxx.reshape(shape)}
        out["uy"] = uy.reshape(shape)
        if not first_y_only:
            out["uyy"] = uyy.reshape(shape)
        return out
    u, (ux,), (uxx,) = mlp_fields(spec, params, X, (0,))
    return {"u": u.reshape(shape), "ux": ux.reshape(shape), "uxx": uxx.reshape(shape)}


def taylor_fields_3d(spec: MLP, params, x, y, z, *, second: bool = True):
    """Fields of the 3D ansatz at x, y, z (same shape): {u, ux, uy, uz} plus
    {uxx, uyy, uzz} when `second`."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    u, firsts, seconds = mlp_fields(spec, params, X, (0, 1, 2), second=second)
    out = {"u": u.reshape(shape)}
    out.update({name: t.reshape(shape) for name, t in zip(("ux", "uy", "uz"), firsts)})
    out.update({name: t.reshape(shape) for name, t in zip(("uxx", "uyy", "uzz"), seconds)})
    return out
