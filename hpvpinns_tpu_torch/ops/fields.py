"""Batched evaluation of an ansatz and its PDE derivatives at quadrature
points, by the JVP engine (ops/derivatives.py).

Counterpart of hpvpinns_tpu/ops/fields.py (the scalar engines in 1, 2 and 3
dimensions, and the vector engines of the Navier-Stokes systems, whose
ansatz has a (u, v, p) output).  All elements' points are batched into
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


def vector_fields_2d(w_fn, x, y, *, firsts_only: bool = False):
    """A vector ansatz and its per-axis derivatives at 2D points x, y
    (identical shapes [..., Qy, Qx]); w_fn maps [P, 2] -> [P, C].  One
    nested-JVP chain per axis differentiates all C components at once (the
    JVP primitives are shape-generic).  {w, wx, wy} plus {wxx, wyy} unless
    firsts_only, each shaped [..., Qy, Qx, C]."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)
    vx, vy = coord_tangent(X, 0), coord_tangent(X, 1)
    if firsts_only:
        w, wx = torch.func.jvp(w_fn, (X,), (vx,))
        wy = dir_deriv(w_fn, X, vy)
        c = w.shape[-1]
        return {"w": w.reshape(shape + (c,)), "wx": wx.reshape(shape + (c,)), "wy": wy.reshape(shape + (c,))}
    w, wx, wxx = value_and_dir_derivs2(w_fn, X, vx)
    _, wy, wyy = value_and_dir_derivs2(w_fn, X, vy)
    c = w.shape[-1]
    return {k: v.reshape(shape + (c,)) for k, v in (("w", w), ("wx", wx), ("wy", wy), ("wxx", wxx), ("wyy", wyy))}


def vector_fields_3d(w_fn, x, y, z, *, second: bool = True):
    """A vector ansatz and its per-axis derivatives at 3D points x, y, z
    (identical shapes [..., Qz, Qy, Qx]); w_fn maps [P, 3] -> [P, C], z is
    time for the unsteady systems.  {w, wx, wy, wz} plus {wxx, wyy} when
    `second` (no wzz: the systems are first order in time), each shaped
    [..., Qz, Qy, Qx, C]."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    vx, vy, vz = coord_tangent(X, 0), coord_tangent(X, 1), coord_tangent(X, 2)
    out = {}
    if second:
        w, wx, wxx = value_and_dir_derivs2(w_fn, X, vx)
        _, wy, wyy = value_and_dir_derivs2(w_fn, X, vy)
        out["wxx"], out["wyy"] = wxx, wyy
    else:
        w, wx = torch.func.jvp(w_fn, (X,), (vx,))
        wy = dir_deriv(w_fn, X, vy)
    out.update(w=w, wx=wx, wy=wy, wz=dir_deriv(w_fn, X, vz))
    c = w.shape[-1]
    return {k: v.reshape(shape + (c,)) for k, v in out.items()}


def scalar_fields_3d(u_fn, x, y, z, *, second: bool = True):
    """The ansatz and its per-axis derivatives at 3D points x, y, z (identical
    shapes [..., Qz, Qy, Qx]); u_fn maps [P, 3] -> [P, 1].  {u, ux, uy, uz}
    plus {uxx, uyy, uzz} when `second`."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    out = {}
    for k, name1, name2 in ((0, "ux", "uxx"), (1, "uy", "uyy"), (2, "uz", "uzz")):
        v = coord_tangent(X, k)
        if second:
            u, d1, d2 = value_and_dir_derivs2(u_fn, X, v)
            out[name2] = d2.reshape(shape)
        else:
            u, d1 = torch.func.jvp(u_fn, (X,), (v,))
        out[name1] = d1.reshape(shape)
    out["u"] = u.reshape(shape)
    return out
