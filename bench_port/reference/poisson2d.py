"""Plain reference of the Poisson-2D hp-VPINN training step.

The problem of record of hp-VPINNs (arXiv:2003.05385, its Poisson-2D
example): Delta u = f on [-1, 1]^2 with

    u(x, y) = (0.1 sin(2 pi x) + tanh(10 x)) sin(2 pi y),   f = Delta u,

Dirichlet data at points on the four edges, a tanh MLP u_theta, and on each
element of a uniform Ex x Ey grid the Petrov-Galerkin residuals of the once
integrated weak form (var_form 1) against the test functions
phi_n = P_{n+1} - P_{n-1} in each direction:

    R[e, k, r] = -int_e grad u_theta . grad(phi_k(eta) phi_r(xi)) - int_e f phi_k phi_r

by Gauss-Lobatto-Legendre quadrature, and the loss

    loss = lossb_weight * mean_b (u_b - u_theta(x_b))^2 + sum_e mean_{k,r} R[e, k, r]^2,

minimised by Adam (betas 0.9, 0.999, eps 1e-8).

Everything here is written out from the mathematics, in plain NumPy (the
quadrature, the basis, the right-hand side, in float64 on the host) and
plain PyTorch (the network, its first derivatives by autograd, the loss and
Adam), in the dtype it is given: float64 for the reference, float32 with
TF32 products for the control.  It imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from numpy.polynomial import legendre

OMEGA = 2.0 * math.pi
STEEP = 10.0
BETAS = (0.9, 0.999)
EPS = 1e-8


def u_exact(x, y):
    return (0.1 * np.sin(OMEGA * x) + np.tanh(STEEP * x)) * np.sin(OMEGA * y)


def f_source(x, y):
    """Delta u: d2/dx2 tanh(a x) = -2 a^2 tanh(a x) sech^2(a x)."""
    gx = 0.1 * np.sin(OMEGA * x) + np.tanh(STEEP * x)
    gxx = -0.1 * OMEGA**2 * np.sin(OMEGA * x) - 2.0 * STEEP**2 * np.tanh(STEEP * x) / np.cosh(STEEP * x) ** 2
    return gxx * np.sin(OMEGA * y) - OMEGA**2 * gx * np.sin(OMEGA * y)


def gll(q: int):
    """Gauss-Lobatto-Legendre nodes (the ends and the roots of P'_{q-1}) and
    weights 2 / (q (q - 1) P_{q-1}(x)^2) on [-1, 1]."""
    p = legendre.Legendre.basis(q - 1)
    inner = np.sort(p.deriv().roots().real)
    for _ in range(3):  # Newton on P'_{q-1}: the companion matrix's roots to the last ulp
        inner -= p.deriv()(inner) / p.deriv(2)(inner)
    x = np.concatenate([[-1.0], inner, [1.0]])
    return x, 2.0 / (q * (q - 1) * p(x) ** 2)


def test_functions(n: int, x: np.ndarray):
    """phi_k = P_{k+1} - P_{k-1} and phi_k' at x, k = 1..n: ([n, len(x)], [n, len(x)])."""
    phi, dphi = [], []
    for k in range(1, n + 1):
        c = np.zeros(k + 2)
        c[k + 1], c[k - 1] = 1.0, -1.0
        phi.append(legendre.legval(x, c))
        dphi.append(legendre.legval(x, legendre.legder(c)))
    return np.asarray(phi), np.asarray(dphi)


@dataclass
class Problem:
    """The training data on `device` in `dtype`: the quadrature points of
    every element as one [P, 2] batch (element-major, then eta, then xi), the
    weighted test functions, the jacobians, the projected right-hand side
    F [E, K, R], and the boundary points and data."""

    points: torch.Tensor
    shape: tuple  # (E, Qy, Qx)
    wphi: torch.Tensor  # [N, Q]: w_q phi_k(x_q)
    wdphi: torch.Tensor  # [N, Q]: w_q phi_k'(x_q)
    jac_x: torch.Tensor  # [E]
    jac_y: torch.Tensor  # [E]
    rhs: torch.Tensor  # [E, K, R]
    xb: torch.Tensor  # [B, 2]
    ub: torch.Tensor  # [B, 1]
    lossb_weight: float


def shapes(cfg: dict, ranks: int) -> dict:
    """What the work of a network's step on one rank is counted from
    (bench_port/work.py): the layers, the quadrature points of the rank's
    share of the elements, two directions, first derivatives only."""
    points = cfg["n_elements_x"] * cfg["n_elements_y"] // ranks * cfg["n_quad"] ** 2
    return {"layers": list(cfg["layers"]), "points": points, "n_dirs": 2, "second": False}


def build(cfg: dict, xb: np.ndarray, dtype=torch.float64, device="cpu") -> Problem:
    """The problem of `cfg` (n_elements_x, n_elements_y, n_quad, n_test_x
    (= n_test_y), domain [-1, 1]^2, lossb_weight) with the boundary points
    `xb` [B, 2], all assembled in float64 and cast to `dtype` at the end."""
    ex, ey, q, n = cfg["n_elements_x"], cfg["n_elements_y"], cfg["n_quad"], cfg["n_test_x"]
    if cfg["n_test_y"] != n or cfg["var_form"] != 1 or cfg["activation"] != "tanh":
        raise ValueError("the reference takes var_form 1, tanh and one test order for both directions")
    xi, w = gll(q)
    phi, dphi = test_functions(n, xi)
    edges_x, edges_y = np.linspace(-1.0, 1.0, ex + 1), np.linspace(-1.0, 1.0, ey + 1)
    jx, jy = np.diff(edges_x) / 2.0, np.diff(edges_y) / 2.0
    cx, cy = (edges_x[:-1] + edges_x[1:]) / 2.0, (edges_y[:-1] + edges_y[1:]) / 2.0
    # element e = i * ey + j: x index i, y index j
    i, j = np.divmod(np.arange(ex * ey), ey)
    X = cx[i][:, None, None] + jx[i][:, None, None] * xi[None, None, :]
    Y = cy[j][:, None, None] + jy[j][:, None, None] * xi[None, :, None]
    X, Y = np.broadcast_to(X, (ex * ey, q, q)), np.broadcast_to(Y, (ex * ey, q, q))
    wphi = w[None, :] * phi
    rhs = (jx[i] * jy[j])[:, None, None] * np.einsum("ky,rx,eyx->ekr", wphi, wphi, f_source(X, Y))
    xb = np.asarray(xb, dtype=np.float64)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64)).to(device=device, dtype=dtype)

    return Problem(
        points=t(np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)), shape=(ex * ey, q, q),
        wphi=t(wphi), wdphi=t(w[None, :] * dphi), jac_x=t(jx[i]), jac_y=t(jy[j]), rhs=t(rhs),
        xb=t(xb), ub=t(u_exact(xb[:, :1], xb[:, 1:])), lossb_weight=float(cfg["lossb_weight"]),
    )


def boundary_points(n: int, rng: np.random.Generator) -> np.ndarray:
    """n points drawn uniformly on each edge of [-1, 1]^2: [4 n, 2]."""
    s = rng.uniform(-1.0, 1.0, size=(4, n))
    one = np.ones(n)
    return np.concatenate([np.stack(e, axis=-1) for e in
                           ((s[0], one), (s[1], -one), (one, s[2]), (-one, s[3]))])


def inputs(cfg: dict, rng: np.random.Generator) -> dict:
    """The data a run draws from its seed and hands to the program, by the
    names of its problem's data: the boundary points and their data."""
    xb = boundary_points(cfg["n_bound"], rng)
    return {"xb": xb, "ub": u_exact(xb[:, :1], xb[:, 1:])}


def mlp(layers, x: torch.Tensor) -> torch.Tensor:
    """tanh hidden layers, a linear output; layers [(W [in, out], b [out])]."""
    h = x
    for W, b in layers[:-1]:
        h = torch.tanh(h @ W + b)
    W, b = layers[-1]
    return h @ W + b


def loss(prob: Problem, layers, half: bool = False) -> torch.Tensor:
    """lossb_weight * lossb + lossv at the network `layers`.  `half` plants
    a fault: lossv over the first half of the elements only, doubled."""
    x = prob.points.detach().requires_grad_(True)
    u = mlp(layers, x)
    (du,) = torch.autograd.grad(u.sum(), x, create_graph=True)
    E, qy, qx = prob.shape
    ux, uy = du[:, 0].reshape(E, qy, qx), du[:, 1].reshape(E, qy, qx)
    U = -(prob.jac_y[:, None, None] * torch.einsum("ky,rx,eyx->ekr", prob.wphi, prob.wdphi, ux)
          + prob.jac_x[:, None, None] * torch.einsum("ky,rx,eyx->ekr", prob.wdphi, prob.wphi, uy))
    R = U - prob.rhs
    if half:
        R = R[: E // 2] * math.sqrt(2.0)
    lossv = (R**2).sum() / (R.shape[1] * R.shape[2])
    lossb = ((prob.ub - mlp(layers, prob.xb)) ** 2).mean()
    return prob.lossb_weight * lossb + lossv


def adam_readings(prob: Problem, layers, lr: float, steps: int = 3, half: bool = False) -> dict:
    """`steps` Adam steps from `layers` (copied, not changed): the loss at the
    start and after each step, every leaf's first gradient, and every leaf's
    change over the steps, as float64 host tensors in leaf order (W, b layer
    by layer)."""
    leaves = [t.detach().clone().requires_grad_(True) for layer in layers for t in layer]
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, first = [], None
    for step in range(1, steps + 1):
        value = loss(prob, list(zip(leaves[::2], leaves[1::2])), half)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        if first is None:
            first = [g.detach().double().cpu() for g in grads]
        with torch.no_grad():
            for p, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                vi.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                m_hat = mi / (1.0 - BETAS[0] ** step)
                v_hat = vi / (1.0 - BETAS[1] ** step)
                p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
    losses.append(float(loss(prob, list(zip(leaves[::2], leaves[1::2])), half).detach()))
    change = [(p.detach().double() - s.double()).cpu() for p, s in zip(leaves, start)]
    return {"loss": losses, "grad": first, "change": change}
