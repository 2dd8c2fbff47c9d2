"""Batched evaluation of an ansatz and its PDE derivatives at quadrature
points, by the JVP engine (ops/derivatives.py).

Counterpart of hpvpinns_tpu/ops/fields.py (the scalar engines; the vector
ones wait for the vector problems).  All elements' points are batched into
one flat [P, d] array and the derivatives come from nested forward-mode JVPs
of the whole ansatz: `deriv_mode="jvp"`, the engine for any ansatz that is
not a bare MLP (the hard-BC composite, an input feature) and for the strong
residual.
"""

from __future__ import annotations

import torch

from hpvpinns_tpu_torch.ops.derivatives import coord_tangent, dir_deriv, value_and_dir_derivs2


def scalar_fields_1d(u_fn, x):
    """(u, u_x, u_xx) at points x of shape [..., Q]; u_fn maps [P, 1] ->
    [P, 1].  Each result is shaped like x."""
    shape = x.shape
    X = x.reshape(-1, 1)
    u, ux, uxx = value_and_dir_derivs2(u_fn, X, coord_tangent(X, 0))
    return u.reshape(shape), ux.reshape(shape), uxx.reshape(shape)


def scalar_fields_2d(
    u_fn, x, y, *,
    second_y: bool = True, first_y_only: bool = False, firsts_only: bool = False,
):
    """The ansatz and its per-axis derivatives at 2D points x, y (identical
    shapes [..., Qy, Qx]); u_fn maps [P, 2] -> [P, 1].

    {u, ux, uxx} plus {uy, uyy} (second_y) or uy alone (first_y_only, the
    AdvDiff case: y is time and only u_t is needed); firsts_only gives
    {u, ux, uy} with no nested (second-order) JVP, the mode of the
    once-integrated forms."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)
    vx = coord_tangent(X, 0)
    if firsts_only:
        u, ux = torch.func.jvp(u_fn, (X,), (vx,))
        uy = dir_deriv(u_fn, X, coord_tangent(X, 1))
        return {"u": u.reshape(shape), "ux": ux.reshape(shape), "uy": uy.reshape(shape)}
    u, ux, uxx = value_and_dir_derivs2(u_fn, X, vx)
    out = {"u": u.reshape(shape), "ux": ux.reshape(shape), "uxx": uxx.reshape(shape)}
    vy = coord_tangent(X, 1)
    if first_y_only:
        out["uy"] = dir_deriv(u_fn, X, vy).reshape(shape)
    elif second_y:
        _, uy, uyy = value_and_dir_derivs2(u_fn, X, vy)
        out["uy"] = uy.reshape(shape)
        out["uyy"] = uyy.reshape(shape)
    return out
