"""PDE differential operators by forward-mode autodiff on point batches.

Counterpart of hpvpinns_tpu/ops/derivatives.py, on `torch.func.jvp`.  The
function acts row-wise on X [P, d], so the directional derivative with a
broadcast coordinate tangent e_k gives each point's partial du/dx_k; one
nested JVP gives (u, d_v u, d_vv u).

`torch.func.jvp` nests (each call opens its own forward-mode level, which a
single `torch.autograd.forward_ad` level would not), and its results carry
reverse-mode gradients to every tensor the function closes over, the
network's parameters included: training takes `backward()` through them
(tests/test_torch_fields_jvp.py checks both against double autograd).
"""

from __future__ import annotations

import torch


def dir_deriv(f, X, v):
    """First directional derivative: d/dt f(X + t v) at t=0."""
    return torch.func.jvp(f, (X,), (v,))[1]


def value_and_dir_derivs2(f, X, v):
    """(f(X), d_v f, d_vv f) by one nested JVP.  f maps [P, d] -> [P, out];
    v is a tangent of X's shape (typically a broadcast coordinate
    direction)."""

    def f_and_first(x):
        return torch.func.jvp(f, (x,), (v,))

    (u, du), (_, d2u) = torch.func.jvp(f_and_first, (X,), (v,))
    return u, du, d2u


def coord_tangent(X, axis: int):
    """Unit tangent along input coordinate `axis`, broadcast over the batch."""
    v = torch.zeros_like(X)
    v[..., axis] = 1.0
    return v
