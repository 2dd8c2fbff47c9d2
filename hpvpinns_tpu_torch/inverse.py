"""Direct variational coefficient recovery: two-phase field identification
and the network-free reduced routes.

Counterpart of hpvpinns_tpu/inverse.py, with the same names, signatures and
returns.  Joint optimization of (solution, coefficient field) is ill-posed:
the network absorbs field error within its own fit.  This module exploits
the structure the weak form exposes instead: **with the solution u FROZEN,
the var_form-1 weak residual is AFFINE in eps(x)**

    Res[e, n](eps) = b[e, n] - sum_j c_j A[e, n, j],
    eps(x) = sum_j c_j P_j(xi(x))                (Legendre expansion)

so identification reduces to ONE dense least-squares solve, with Tikhonov
regularization by an exact derivative-energy penalty.  The reduced routes
eliminate u instead: they solve the forward problem exactly per candidate
coefficient (galerkin.py) and minimize the sensor misfit.

Where the arithmetic runs.  What the JAX package computes in numpy/scipy
(the Legendre and spectral bases, the least-squares solves, the outer
searches, the direct solvers) stays host float64 numpy/scipy here.  What it
computes in jax runs in torch on the device of the `problem` and in its
dtype: the frozen ansatz's fields (ops/fields.py) and the weak-form
contractions (ops/contract.py), batched over the columns of the linear
system; only the assembled system goes to float64 numpy for the solve.
`reduced_identify_field` propagates with torch.linalg.matrix_exp under
autograd, in float64 on the problem's device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from hpvpinns_tpu_torch.ops.contract import contract_2d, contract_3d
from hpvpinns_tpu_torch.ops.fields import scalar_fields_2d, scalar_fields_3d
from hpvpinns_tpu_torch.spectral.jacobi import djacobi, jacobi_all


def host(a) -> np.ndarray:
    """float64 numpy of a tensor on any device (detached), or of an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def interior_sensors(problem, dims: int = 1):
    """(Xs, ds) as float64 numpy: the sensor rows of problem.data["xb"/"ub"]
    strictly inside the space domain and after t = 0 (boundary and initial
    rows carry no coefficient information).  dims = 1 for the 1D
    space-time family ([x, t] rows), 2 for the 2D one ([x, y, t])."""
    cfg = problem.config
    Xb = host(problem.data["xb"])
    ub = host(problem.data["ub"]).reshape(-1)
    sel = Xb[:, dims] > 1e-12
    domains = (cfg.domain_x,) if dims == 1 else (cfg.domain_x, cfg.domain_y)
    for k, (lo, hi) in enumerate(domains):
        sel &= (Xb[:, k] > lo + 1e-12) & (Xb[:, k] < hi - 1e-12)
    return Xb[sel], ub[sel]


def legendre_field(coef: np.ndarray, domain=(-1.0, 1.0)):
    """eps(x) callable from Legendre coefficients on `domain` (numpy)."""
    coef = np.asarray(coef, dtype=np.float64)
    a, b = domain
    half = (b - a) / 2.0

    def eps_fn(x):
        xi = (x - (a + b) / 2.0) / half
        P = jacobi_all(len(coef) - 1, 0.0, 0.0, xi)
        out = 0.0
        for j in range(len(coef)):
            out = out + coef[j] * P[j]
        return out

    return eps_fn


def _legendre_grid(order: int, xi: np.ndarray, half: float):
    """(P [order, ...], dP/dx [order, ...]) of the mapped Legendre basis."""
    P = jacobi_all(order - 1, 0.0, 0.0, xi)
    dP = np.stack([djacobi(j, 0.0, 0.0, xi, 1) / half for j in range(order)])
    return P, dP


def _on_elements(el):
    """An array to the elements' device and dtype."""
    return lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=el.x.device, dtype=el.x.dtype)


def _weak_fit_arrays(problem):
    """An advdiff problem's weak-form tensors on its device and in its dtype
    (jac, jt, mask, f_proj, the weighted bases), the quadrature points as
    float64 numpy, `on` (an array to that device and dtype) and the
    sum-factorized contraction C: the common substrate of the linear-fit and
    ALS machinery.  C takes [..., Qt, Qx] fields (a leading batch of
    columns) to [..., K, R]."""
    el = problem.data["elements"]
    bx, bt = problem.data["basis_x"], problem.data["basis_t"]
    return {
        "el": el,
        "x": host(el.x),
        "on": _on_elements(el),
        "jac": (el.jac_x * el.jac_y)[:, None, None],
        "jt": el.jac_y[:, None, None],
        "wphi_x": bx.wphi,
        "wdphi_x": bx.wdphi,
        "wphi_t": bt.wphi,
        "mask": el.mask,
        "f_proj": el.f_proj,
        "C": contract_2d,
    }


def _u_fields(problem, params, u_fn=None):
    """(u_t, u_x) of the frozen ansatz (or an override u_fn, torch [P, 2] ->
    [P, 1]) at the quadrature points, by the JVP engine, on the problem's
    device and in its dtype."""
    el = problem.data["elements"]
    if u_fn is None:
        u_fn = lambda X: problem.apply(params, X)  # noqa: E731
    with torch.no_grad():
        flds = scalar_fields_2d(u_fn, el.x, el.y, first_y_only=True)
    return flds["uy"], flds["ux"]


def _columns(block, mask) -> np.ndarray:
    """[rows, J] float64 numpy from a [J, E, ...] block of residual columns."""
    return host((block * mask).reshape(block.shape[0], -1)).T


def _velocity_at(problem, params, x):
    """The advection velocity of `params` at the quadrature points x (the
    problem's v_of, else its scalar), a tensor on x's device and in its
    dtype, broadcastable against x."""
    v_of = problem.extras.get("v_of")
    with torch.no_grad():
        v = v_of(params, x) if v_of is not None else problem.config.velocity
        return torch.as_tensor(v).detach().to(device=x.device, dtype=x.dtype)


def fit_epsilon_field(problem, params, order: int = 8, reg: float = 0.0, u_fn=None):
    """Recover a space-dependent diffusion field eps(x) by linear least
    squares against the frozen trained solution.

    problem: a built advdiff Problem (1D space-time); params: trained
    parameters (u and, if trainable, the velocity are FROZEN: only eps is
    solved for).  order: number of Legendre modes; reg: Tikhonov weight on
    the exact derivative energy  int eps'(x)^2 dx (scale-matched to the
    residual rows).  u_fn overrides the frozen ansatz (oracle/analytic
    solutions in tests; torch [P, 2] -> [P, 1]).

    Returns (coef [order], eps_fn, info) where info carries the per-row
    residual norms before/after and the raw linear system.
    """
    if problem.name != "advdiff":
        raise ValueError(f"fit_epsilon_field supports advdiff problems, got {problem.name!r}")
    cfg = problem.config
    el = problem.data["elements"]
    ut, ux = _u_fields(problem, params, u_fn)

    W = _weak_fit_arrays(problem)
    on, jac, jt, mask, C = W["on"], W["jac"], W["jt"], W["mask"], W["C"]
    wphi_x, wdphi_x, wphi_t = W["wphi_x"], W["wdphi_x"], W["wphi_t"]
    V = _velocity_at(problem, params, el.x)
    a_dom, b_dom = cfg.domain_x
    half = (b_dom - a_dom) / 2.0
    P, dP = (on(a) for a in _legendre_grid(order, (W["x"] - (a_dom + b_dom) / 2.0) / half, half))

    # rhs: the eps-free part of the form-1 residual (= f_proj - advection part)
    b_flat = host((W["f_proj"] - jac * C(wphi_x, wphi_t, ut + V * ux)) * mask).reshape(-1)
    # columns: the eps-dependent part per Legendre mode
    A = _columns(jac * C(wphi_x, wphi_t, dP * ux) + jt * C(wdphi_x, wphi_t, P * ux), mask)

    if reg > 0:
        # Exact derivative-energy Gram matrix of the mapped Legendre basis:
        # int_a^b P'_j P'_k dx, by Gauss-Lobatto quadrature once.
        from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi

        xq, wq = gauss_lobatto_jacobi(2 * order + 2, 0.0, 0.0)
        dPq = np.stack([djacobi(j, 0.0, 0.0, xq, 1) / half for j in range(order)])
        G = np.einsum("q,jq,kq->jk", wq * half, dPq, dPq)
        # scale-match the penalty to the residual rows (mean row energy)
        lam = reg * (A * A).sum() / max(A.shape[0], 1)
        w, Vg = np.linalg.eigh(G)
        L = (Vg * np.sqrt(np.maximum(w, 0.0))) @ Vg.T
        A_aug = np.vstack([A, np.sqrt(lam) * L])
        b_aug = np.concatenate([b_flat, np.zeros(order)])
    else:
        A_aug, b_aug = A, b_flat

    coef, *_ = np.linalg.lstsq(A_aug, b_aug, rcond=None)
    info = {
        "residual_before": float(np.linalg.norm(b_flat)),
        "residual_after": float(np.linalg.norm(A @ coef - b_flat)),
        "order": order,
        # the raw linear system, for the closed-form covariance of the
        # estimate (uncertainty.lstsq_covariance)
        "A": A, "b": b_flat,
        "reg_gram": (lam * (L.T @ L)) if reg > 0 else None,
    }
    return coef, legendre_field(coef, cfg.domain_x), info


def fit_coefficient_fields(
    problem, params, eps_order: int = 6, vel_order: int = 0,
    reg: float = 0.0, u_fn=None,
):
    """Jointly recover eps(x) AND V(x) by ONE linear least-squares solve.

    With u frozen, the form-1 weak residual is affine in BOTH coefficient
    fields (eps through the diffusion IBP pair, V through the advection
    term).  `vel_order=0` freezes the velocity at the problem's own
    (trainable or true) field and reduces to fit_epsilon_field's problem.

    IDENTIFIABILITY CAP (measured in the JAX package): the non-divergence
    weak form aliases V(x) against -d(eps)/dx; joint recovery is accurate
    for vel_order <= 2 and degrades sharply above.  For richer velocity
    fields identify V first and pass vel_order=0.

    Returns (eps_coef, eps_fn, vel_coef, vel_fn, info); vel_coef/vel_fn are
    None when vel_order=0.  Tikhonov `reg` penalizes the coefficients in
    unit-column scaling.
    """
    if problem.name != "advdiff":
        raise ValueError(f"fit_coefficient_fields supports advdiff problems, got {problem.name!r}")
    cfg = problem.config
    el = problem.data["elements"]
    ut, ux = _u_fields(problem, params, u_fn)

    W = _weak_fit_arrays(problem)
    on, jac, jt, mask, C = W["on"], W["jac"], W["jt"], W["mask"], W["C"]
    wphi_x, wdphi_x, wphi_t = W["wphi_x"], W["wdphi_x"], W["wphi_t"]
    a_dom, b_dom = cfg.domain_x
    half = (b_dom - a_dom) / 2.0
    n_modes = max(eps_order, vel_order)
    P, dP = (on(a) for a in _legendre_grid(n_modes, (W["x"] - (a_dom + b_dom) / 2.0) / half, half))

    if vel_order > 0:
        # rhs holds only the coefficient-free physics (time derivative)
        g = ut
    else:
        g = ut + _velocity_at(problem, params, el.x) * ux
    b_flat = host((W["f_proj"] - jac * C(wphi_x, wphi_t, g)) * mask).reshape(-1)

    blocks = [jac * C(wphi_x, wphi_t, dP[:eps_order] * ux) + jt * C(wdphi_x, wphi_t, P[:eps_order] * ux)]
    if vel_order:  # advection block
        blocks.append(jac * C(wphi_x, wphi_t, P[:vel_order] * ux))
    A = _columns(torch.cat(blocks), mask)

    # Column equilibration: the eps block's columns are O(eps/V) smaller
    # than the velocity block's, so solve in unit-column scaling.
    coef = _lstsq_equilibrated(A, b_flat, reg)
    eps_coef = coef[:eps_order]
    info = {
        "residual_before": float(np.linalg.norm(b_flat)),
        "residual_after": float(np.linalg.norm(A @ coef - b_flat)),
        "eps_order": eps_order,
        "vel_order": vel_order,
    }
    vel_coef = coef[eps_order:] if vel_order else None
    vel_fn = legendre_field(vel_coef, cfg.domain_x) if vel_order else None
    return eps_coef, legendre_field(eps_coef, cfg.domain_x), vel_coef, vel_fn, info


def _lstsq_equilibrated(A: np.ndarray, b: np.ndarray, reg: float) -> np.ndarray:
    """argmin ||A c - b||^2 in unit-column scaling with the scale-matched
    ridge reg * mean row energy (none at reg 0), unscaled."""
    cs = np.linalg.norm(A, axis=0)
    cs[cs == 0] = 1.0
    A_s = A / cs
    lam = reg * (A_s * A_s).sum() / max(A.shape[0], 1)
    A_aug = np.vstack([A_s, np.sqrt(lam) * np.eye(A.shape[1])])
    b_aug = np.concatenate([b.reshape(-1), np.zeros(A.shape[1])])
    coef, *_ = np.linalg.lstsq(A_aug, b_aug, rcond=None)
    return coef / cs


def _known_velocity_params(problem):
    """The parameters whose velocity the ALS routes treat as known: the
    problem's own draw from a torch.Generator seeded 0 (the JAX package
    draws from jax.random.key(0)); the velocity is the true one, or
    velocity_init on a trainable-velocity problem, whatever the draw."""
    return problem.init_params(torch.Generator().manual_seed(0))


def als_identify(
    problem,
    space_order: int = 16,
    time_order: int = 12,
    eps_order: int = 8,
    w_data: float = 10.0,
    eps_reg: float = 1e-8,
    iters: int = 6,
    eps_init: float = 0.1,
):
    """NETWORK-FREE inverse identification by alternating linear least
    squares: the weak residual is BILINEAR in (u, eps), so alternating

        eps fixed  ->  u = argmin ||weak rows||^2 + w_data^2 ||data rows||^2
                       (u in a global spectral tensor basis: boundary-
                        vanishing bubbles in x, Legendre in t: LINEAR)
        u fixed    ->  eps(x) by the direct Legendre fit (LINEAR)

    converges in 2-3 rounds with no optimizer and no network, in the clean
    dense-data regime.

    Requires: 1D space-time advdiff problem with homogeneous side walls.
    The velocity is treated as KNOWN: it is read from the problem's initial
    parameters, so on a `velocity_trainable=True` problem that is
    `velocity_init`, NOT the truth (warned).  Use `fit_coefficient_fields` /
    `reduced_identify` for joint (eps, V).

    Returns (u_fn, eps_coef, eps_fn, info): u_fn(X [P,2]) -> [P,1] (numpy)
    evaluates the recovered solution; info carries the per-round
    trajectories.
    """
    from hpvpinns_tpu_torch.spectral.basis import make_test_basis

    if getattr(problem.config, "velocity_trainable", False):
        warnings.warn(
            "als_identify treats the velocity as KNOWN but this problem has "
            "velocity_trainable=True: the value used is velocity_init "
            f"({problem.config.velocity_init}), not the truth. Identify "
            "(eps, V) jointly with fit_coefficient_fields/reduced_identify "
            "instead.",
            stacklevel=2,
        )

    if problem.name != "advdiff":
        raise ValueError(f"als_identify supports advdiff problems, got {problem.name!r}")
    cfg = problem.config
    el = problem.data["elements"]
    T = cfg.t_final
    a_dom, b_dom = cfg.domain_x
    half = (b_dom - a_dom) / 2.0

    W = _weak_fit_arrays(problem)
    on, jac, jt, mask, C = W["on"], W["jac"], W["jt"], W["mask"], W["C"]
    wphi_x, wdphi_x, wphi_t = W["wphi_x"], W["wdphi_x"], W["wphi_t"]
    x_g = W["x"]  # [E, Qt, Qx]
    t_g = host(el.y)

    def space_basis(x):
        """phi_i, phi_i' at arbitrary points (mapped bubbles; vanish at the
        walls)."""
        xi = (np.asarray(x, dtype=np.float64).reshape(-1) - (a_dom + b_dom) / 2.0) / half
        tb = make_test_basis(space_order, xi)
        return np.asarray(tb.phi), np.asarray(tb.dphi) / half  # [S, P]

    def time_basis(t):
        tau = 2.0 * np.asarray(t, dtype=np.float64).reshape(-1) / T - 1.0
        P = np.asarray(jacobi_all(time_order - 1, 0.0, 0.0, tau))
        dP = np.stack([djacobi(m, 0.0, 0.0, tau, 1) * 2.0 / T for m in range(time_order)])
        return P, dP  # [M, P]

    shape = x_g.shape
    PHI, dPHI = (a.reshape((space_order,) + shape) for a in space_basis(x_g))
    PSI, dPSI = (a.reshape((time_order,) + shape) for a in time_basis(t_g))

    V_d = _velocity_at(problem, _known_velocity_params(problem), el.x)

    b_weak = host(W["f_proj"] * mask).reshape(-1)
    n_c = space_order * time_order

    # Data rows from the problem's own sampled data (boundary + IC + sensors).
    Xb = host(problem.data["xb"])
    ub = host(problem.data["ub"]).reshape(-1)
    Ps_d, _ = space_basis(Xb[:, 0])
    Pt_d, _ = time_basis(Xb[:, 1])
    B_data = (Ps_d[:, None, :] * Pt_d[None, :, :]).reshape(n_c, -1).T  # [n_data, n_c]

    # the u-basis columns' u_t and u_x at the quadrature points, column
    # k = i * time_order + m, on the device
    ut_cols = (on(dPSI)[None] * on(PHI)[:, None]).reshape((n_c,) + shape)
    ux_cols = (on(PSI)[None] * on(dPHI)[:, None]).reshape((n_c,) + shape)

    def u_solve(eps_q, epsx_q):
        r = jac * C(wphi_x, wphi_t, ut_cols + (V_d + on(epsx_q)) * ux_cols) + jt * C(
            wdphi_x, wphi_t, on(eps_q) * ux_cols
        )
        A_full = np.vstack([_columns(r, mask), w_data * B_data])
        b_full = np.concatenate([b_weak, w_data * ub])
        c, *_ = np.linalg.lstsq(A_full, b_full, rcond=None)
        return c

    xi = (x_g - (a_dom + b_dom) / 2.0) / half
    P_leg, dP_leg = (on(a) for a in _legendre_grid(eps_order, xi, half))

    def eps_solve(c):
        cm = c.reshape(space_order, time_order)
        ut = on(np.einsum("im,m...,i...->...", cm, dPSI, PHI))
        ux = on(np.einsum("im,m...,i...->...", cm, PSI, dPHI))
        b_vec = host((W["f_proj"] - jac * C(wphi_x, wphi_t, ut + V_d * ux)) * mask)
        A = _columns(jac * C(wphi_x, wphi_t, dP_leg * ux) + jt * C(wdphi_x, wphi_t, P_leg * ux), mask)
        return _lstsq_equilibrated(A, b_vec, eps_reg)

    eps_coef = np.zeros(eps_order)
    eps_coef[0] = eps_init
    history = []
    c = None
    for _ in range(iters):
        eps_fn_k = legendre_field(eps_coef, cfg.domain_x)
        eps_q = np.asarray(eps_fn_k(x_g))
        h = 1e-6
        epsx_q = (np.asarray(eps_fn_k(x_g + h)) - np.asarray(eps_fn_k(x_g - h))) / (2 * h)
        c = u_solve(eps_q, epsx_q)
        eps_coef = eps_solve(c)
        history.append([float(v) for v in eps_coef])

    eps_fn = legendre_field(eps_coef, cfg.domain_x)
    cm = c.reshape(space_order, time_order)

    def u_fn(X):
        X = np.asarray(X, dtype=np.float64)
        Ps, _ = space_basis(X[:, 0])
        Pt, _ = time_basis(X[:, 1])
        return np.einsum("im,ip,mp->p", cm, Ps, Pt).reshape(-1, 1)

    info = {
        "eps_coef_history": history,
        "space_order": space_order,
        "time_order": time_order,
        "eps_order": eps_order,
    }
    return u_fn, eps_coef, eps_fn, info


def _no_sensors():
    return ValueError("problem has no interior sensors — nothing to identify from")


def exact_initial(exact):
    """The exact initial condition u(x, 0) of a 1D space-time problem."""
    return lambda x: np.asarray(exact(x.reshape(-1, 1), np.zeros((x.size, 1)))).reshape(x.shape)


def reduced_identify(
    problem,
    eps_order: int = 1,
    bounds=(1e-4, 1.5),
    p: int = 40,
    xatol: float = 1e-12,
    x0=None,
    maxiter: int = 400,
    identify_velocity: bool = False,
):
    """Reduced-formulation identification: eliminate u entirely by solving
    the FORWARD problem exactly per candidate coefficient and minimizing the
    sensor-data misfit

        eps* = argmin_eps  sum_s ( u_galerkin(eps)(x_s, t_s) - d_s )^2

    with galerkin.solve_advdiff (spectral in x, expm-exact in t) as the
    inner solver.  A SCALAR coefficient (eps_order=1) is a bounded Brent
    search; Legendre FIELDS (eps_order >= 2) a Nelder-Mead loop, which the
    JAX package measured to stall near ~0.33 field rel-L2 (use
    reduced_identify_field or als_identify for fields).

    Uses the problem's interior sensors as data and the problem's exact
    initial condition.  Homogeneous side walls required (solve_advdiff).

    `identify_velocity=True` ALSO identifies the scalar advection velocity
    jointly (Nelder-Mead over (eps, V); scalar eps only).

    Returns (coef, eps_fn, info) with info = {misfit, n_solves, method};
    with identify_velocity the recovered V is info["velocity"].
    """
    from hpvpinns_tpu_torch.galerkin import solve_advdiff

    if problem.name != "advdiff":
        raise ValueError(f"reduced_identify supports advdiff problems, got {problem.name!r}")
    cfg = problem.config
    mesh = problem.extras["mesh"]
    vfn = problem.extras.get("velocity_fn")
    vel = vfn if vfn is not None else cfg.velocity
    f_fn = problem.extras.get("f_rhs")
    u0 = exact_initial(problem.exact)

    Xs, ds = interior_sensors(problem)
    if Xs.shape[0] == 0:
        raise _no_sensors()
    a_dom, b_dom = cfg.domain_x

    n_solves = [0]
    _xchk = np.linspace(a_dom, b_dom, 129)
    _d0 = float(np.sum(ds**2)) + 1.0  # penalty scale for infeasible candidates

    def misfit(coef):
        coef = np.atleast_1d(np.asarray(coef, dtype=np.float64))
        if len(coef) == 1:
            eps = float(coef[0])
            emin = eps
        else:
            eps = legendre_field(coef, cfg.domain_x)
            emin = float(np.min(np.asarray(eps(_xchk))))
        if emin <= 0:
            # anti-diffusion blows the forward solve up (expm overflow):
            # smooth infeasibility penalty instead of a solve
            return _d0 * (1.0 + abs(emin))
        sol = solve_advdiff(mesh.axis_x, p, u0, eps, vel, f_fn=f_fn)
        n_solves[0] += 1
        return float(np.sum((sol(Xs[:, 0], Xs[:, 1]) - ds) ** 2))

    if identify_velocity:
        if eps_order != 1:
            raise ValueError("identify_velocity requires eps_order=1 (scalar eps)")
        from scipy.optimize import minimize

        def misfit_ev(z):
            eps_c, V_c = float(z[0]), float(z[1])
            if eps_c <= 0:
                return _d0 * (1.0 + abs(eps_c))
            sol = solve_advdiff(mesh.axis_x, p, u0, eps_c, V_c, f_fn=f_fn)
            n_solves[0] += 1
            return float(np.sum((sol(Xs[:, 0], Xs[:, 1]) - ds) ** 2))

        z0 = [0.5 * (bounds[0] + bounds[1]), 0.5] if x0 is None else list(x0)
        res = minimize(
            misfit_ev, np.asarray(z0, dtype=np.float64), method="Nelder-Mead",
            options={"xatol": xatol, "fatol": 1e-20, "maxiter": maxiter},
        )
        coef = np.array([res.x[0]])
        return coef, legendre_field(coef, cfg.domain_x), {
            "misfit": float(res.fun), "n_solves": n_solves[0],
            "method": "nelder-mead (eps, V)", "velocity": float(res.x[1]),
        }

    if eps_order == 1:
        from scipy.optimize import minimize_scalar

        res = minimize_scalar(misfit, bounds=bounds, method="bounded", options={"xatol": xatol})
        coef = np.array([res.x])
        method = "brent-bounded"
    else:
        from scipy.optimize import minimize

        if x0 is None:
            x0 = np.zeros(eps_order)
            x0[0] = 0.5 * (bounds[0] + bounds[1])
        res = minimize(
            misfit, np.asarray(x0, dtype=np.float64), method="Nelder-Mead",
            options={"xatol": xatol, "fatol": 1e-18, "maxiter": maxiter},
        )
        coef = np.asarray(res.x)
        method = "nelder-mead"

    return coef, legendre_field(coef, cfg.domain_x), {
        "misfit": float(res.fun), "n_solves": n_solves[0], "method": method,
    }


def reduced_identify2d(
    problem,
    p: int = 12,
    x0=None,
    xatol: float = 1e-10,
    maxiter: int = 400,
):
    """Reduced-formulation identification for the 2D space-time family:
    Nelder-Mead over (eps, vx, vy) with the exact tensor-product forward
    solver (galerkin.solve_advdiff2d) in the inner loop, minimizing the
    interior-sensor misfit.

    Returns (coef [eps, vx, vy], info).  Requires homogeneous side walls
    (the advdiff2d family's manufactured problem satisfies them).
    """
    from scipy.optimize import minimize

    from hpvpinns_tpu_torch.galerkin import solve_advdiff2d

    if problem.name != "advdiff2d":
        raise ValueError(f"reduced_identify2d supports advdiff2d problems, got {problem.name!r}")
    mesh = problem.extras["mesh"]
    f_fn = problem.extras["f_rhs"]
    exact = problem.exact
    u0 = lambda X, Y: np.asarray(exact(X, Y, np.zeros_like(X)))  # noqa: E731

    Xs, ds = interior_sensors(problem, dims=2)
    if Xs.shape[0] == 0:
        raise _no_sensors()

    n_solves = [0]
    _d0 = float(np.sum(ds**2)) + 1.0

    def misfit(z):
        eps_c, vx_c, vy_c = (float(v) for v in z)
        if eps_c <= 0:
            return _d0 * (1.0 + abs(eps_c))
        sol = solve_advdiff2d(mesh.axis_x, mesh.axis_y, p, u0, eps_c, vx_c, vy_c, f_fn=f_fn)
        n_solves[0] += 1
        return float(np.sum((sol(Xs[:, 0], Xs[:, 1], Xs[:, 2]) - ds) ** 2))

    if x0 is None:
        x0 = [0.5, 0.5, 0.5]
    res = minimize(
        misfit, np.asarray(x0, dtype=np.float64), method="Nelder-Mead",
        options={"xatol": xatol, "fatol": 1e-20, "maxiter": maxiter},
    )
    return np.asarray(res.x), {"misfit": float(res.fun), "n_solves": n_solves[0], "method": "nelder-mead"}


def reduced_identify_field(
    problem,
    eps_order: int = 8,
    p: int = 24,
    eps_init: float = 0.1,
    maxiter: int = 300,
    smooth_reg: float = 0.0,
):
    """Differentiable reduced-formulation FIELD identification: eps(x) by
    gradient-based optimization THROUGH the exact forward solver.

    The semi-discrete operator is rebuilt in torch from fixed basis tensors
    (float64, on the problem's device), propagated with
    torch.linalg.matrix_exp (one batched call over the sensor times), and
    the sensor misfit minimized by scipy's L-BFGS-B with EXACT autograd
    gradients.  eps is LOG-parameterized (eps = exp(sum_j s_j P_j)):
    positive by construction, so no infeasible forward solves.  The JAX
    package measured it the sparse- and noisy-data field route (clean 7x5
    sensors: 2.4e-2 field rel-L2).

    Requires: homogeneous side walls and forcing that is absent or
    separable f = e^{-rt} g(x) (auto-detected; non-separable forcing
    raises).

    Returns (s_coef, eps_fn, info); eps_fn evaluates exp(P s) on numpy
    arrays; info["predict"] is the differentiable forward map, torch [J] ->
    [n_sensors] on the problem's device (uncertainty.reduced_field_ci).
    """
    from scipy.optimize import minimize

    from hpvpinns_tpu_torch.galerkin import _axis_h0_quadrature, _detect_exp_decay

    if problem.name != "advdiff":
        raise ValueError(f"reduced_identify_field supports advdiff problems, got {problem.name!r}")
    cfg = problem.config
    mesh = problem.extras["mesh"]
    vfn = problem.extras.get("velocity_fn")
    f_fn = problem.extras.get("f_rhs")
    a_dom, b_dom = cfg.domain_x
    half = (b_dom - a_dom) / 2.0

    B, Bx, wq, x_g, point_eval, M = _axis_h0_quadrature(mesh.axis_x, p, 2 * p + 2)
    V_g = np.broadcast_to(np.asarray(vfn(x_g) if vfn is not None else cfg.velocity, dtype=np.float64), x_g.shape)

    xi_g = (x_g - (a_dom + b_dom) / 2.0) / half
    P_leg, dP_leg = _legendre_grid(eps_order, xi_g, half)
    T_adv = (B * (wq * V_g)) @ Bx.T
    T1 = np.einsum("aq,q,bq->abq", B, wq, Bx)  # eps_x term
    T2 = np.einsum("aq,q,bq->abq", Bx, wq, Bx)  # eps term

    u0_g = exact_initial(problem.exact)(x_g)
    c0 = np.linalg.solve(M, (B * wq) @ u0_g)
    M_inv = np.linalg.inv(M)

    rate, b_sep = 0.0, np.zeros_like(c0)
    has_f = f_fn is not None
    if has_f:
        rate = _detect_exp_decay(f_fn, (x_g[:, None],))
        if rate is None:
            raise ValueError("reduced_identify_field requires separable forcing f = e^{-rt} g(x) (detection failed)")
        g0 = np.asarray(f_fn(x_g[:, None], np.zeros((len(x_g), 1)))).reshape(-1)
        b_sep = np.linalg.solve(M, (B * wq) @ g0)

    Xs, ds = interior_sensors(problem)
    if Xs.shape[0] == 0:
        raise _no_sensors()
    ts_u, ts_inv = np.unique(Xs[:, 1], return_inverse=True)
    B_s = point_eval(Xs[:, 0])

    device = problem.data["xb"].device
    f64 = dict(dtype=torch.float64, device=device)
    J = {k: torch.as_tensor(v).to(**f64) for k, v in dict(
        T_adv=T_adv, T1=T1, T2=T2, Minv=M_inv, c0=c0, b=b_sep,
        P=P_leg, dP=dP_leg, Bs=B_s, ds=ds, ts=ts_u,
    ).items()}
    I = torch.eye(T_adv.shape[0], **f64)
    rows = torch.as_tensor(ts_inv.reshape(-1), device=device)
    cols = torch.arange(len(ds), device=device)

    def predict(s):
        """Sensor predictions [n_sensors] for log-Legendre coefficients s (a
        float64 tensor on the problem's device, or an array): the
        differentiable forward map."""
        if not isinstance(s, torch.Tensor):
            s = torch.as_tensor(np.asarray(s, dtype=np.float64)).to(**f64)
        eps_q = torch.exp(J["P"].T @ s)
        epsx_q = eps_q * (J["dP"].T @ s)
        Op = J["T_adv"] + torch.einsum("abq,q->ab", J["T1"], epsx_q) + torch.einsum("abq,q->ab", J["T2"], eps_q)
        A = -(J["Minv"] @ Op)
        E_t = torch.linalg.matrix_exp(A[None] * J["ts"][:, None, None])  # [T, n, n], one per sensor time
        C = E_t @ J["c0"]
        if has_f:
            inv_ArI = torch.linalg.solve(A + rate * I, I)
            C = C + (E_t @ J["b"] - torch.exp(-rate * J["ts"])[:, None] * J["b"]) @ inv_ArI.T
        return (C @ J["Bs"])[rows, cols]

    def misfit(s):
        m = torch.sum((predict(s) - J["ds"]) ** 2)
        if smooth_reg > 0:
            # Tikhonov smoothness on the LOG field (mean s'(x)^2 over the
            # quadrature grid), the measured sparse+noisy lever
            m = m + smooth_reg * torch.mean((J["dP"].T @ s) ** 2)
        return m

    n_evals = [0]

    def fun(z):
        s = torch.as_tensor(z).to(**f64).requires_grad_(True)
        with torch.enable_grad():
            v = misfit(s)
            (g,) = torch.autograd.grad(v, s)
        n_evals[0] += 1
        return float(v.detach()), host(g)

    x0 = np.zeros(eps_order)
    x0[0] = np.log(eps_init)
    res = minimize(
        fun, x0, jac=True, method="L-BFGS-B",
        options={"maxiter": maxiter, "ftol": 1e-18, "gtol": 1e-14},
    )
    s_coef = np.asarray(res.x)

    def eps_fn(x):
        xi = (np.asarray(x, dtype=np.float64) - (a_dom + b_dom) / 2.0) / half
        Pv = np.asarray(jacobi_all(eps_order - 1, 0.0, 0.0, xi.reshape(-1)))
        return np.exp(Pv.T @ s_coef).reshape(np.shape(x))

    return s_coef, eps_fn, {
        "misfit": float(res.fun), "n_evals": n_evals[0], "method": "lbfgsb-adjoint",
        "predict": predict, "sensor_values": ds, "n_sensors": int(len(ds)),
    }


def reduced_identify_burgers(
    problem,
    stations=(-0.75, -0.5, -0.25, 0.25, 0.5, 0.75),
    n_per_station: int = 5,
    noise: float = 0.0,
    seed: int = 0,
    bounds=(1e-4, 0.1),
    p: int = 20,
    n_steps: int = 600,
    xatol: float = 1e-12,
):
    """VISCOSITY identification for the nonlinear family: Brent-search nu
    with the spectral-element Burgers solver (galerkin.solve_burgers) in
    the loop, minimizing the misfit against sensor readings of the
    Cole-Hopf exact solution (+ optional Gaussian noise).  Sensors are
    sampled here (LHS times per station, from numpy default_rng(seed), the
    JAX package's draws).

    Returns (nu_hat, info).
    """
    from scipy.optimize import minimize_scalar

    from hpvpinns_tpu_torch.galerkin import BURGERS_SOLVER_GRID, solve_burgers
    from hpvpinns_tpu_torch.geometry.mesh import Interval1D
    from hpvpinns_tpu_torch.utils.sampling import lhs_interval

    if problem.name != "burgers":
        raise ValueError(f"reduced_identify_burgers supports burgers problems, got {problem.name!r}")
    cfg = problem.config
    rng = np.random.default_rng(seed)
    pts, vals = [], []
    for st in stations:
        ts = cfg.t_final * lhs_interval(0, 1, n_per_station, rng).reshape(-1)
        xs = np.full_like(ts, st)
        pts.append(np.stack([xs, ts], axis=-1))
        vals.append(np.asarray(problem.exact(xs[:, None], ts[:, None])).reshape(-1))
    Xs = np.concatenate(pts)
    ds = np.concatenate(vals)
    if noise > 0:
        ds = ds + rng.normal(0.0, noise, ds.shape)

    axis = Interval1D(np.asarray(BURGERS_SOLVER_GRID, dtype=np.float64))
    n_solves = [0]

    def misfit(nu):
        sol = solve_burgers(axis, p, lambda x: -np.sin(np.pi * x), float(nu), cfg.t_final, n_steps)
        n_solves[0] += 1
        return float(np.sum((sol(Xs[:, 0], Xs[:, 1]) - ds) ** 2))

    res = minimize_scalar(misfit, bounds=bounds, method="bounded", options={"xatol": xatol})
    return float(res.x), {
        "misfit": float(res.fun), "n_solves": n_solves[0],
        "n_sensors": len(ds), "method": "brent-bounded",
    }


def _weak_fit_arrays_3d(problem):
    """The advdiff2d twin of _weak_fit_arrays: jac, jx, jy [E, 1, 1, 1] and
    the weighted bases on the problem's device and in its dtype, the
    quadrature points as float64 numpy, `on` and contract_3d."""
    el = problem.data["elements"]
    bx, by, bt = problem.data["basis_x"], problem.data["basis_y"], problem.data["basis_t"]

    def col(a):
        return a[:, None, None, None]

    return {
        "el": el, "x": host(el.x), "y": host(el.y), "t": host(el.z), "on": _on_elements(el),
        "jac": col(el.jac_x * el.jac_y * el.jac_z), "jx": col(el.jac_y * el.jac_z), "jy": col(el.jac_x * el.jac_z),
        "wphi_x": bx.wphi, "wdphi_x": bx.wdphi, "wphi_y": by.wphi, "wdphi_y": by.wdphi, "wphi_t": bt.wphi,
        "mask": el.mask, "f_proj": el.f_proj, "C": contract_3d,
    }


def _eps2d_columns(W, Pjx, dPjx, Pky, dPky, ux, uy):
    """[J*K, E, M, K', R] weak-residual columns of the tensor-Legendre map
    modes P_j(x) P_k(y) (column j * K + k), on the device."""
    C, jac, jx, jy = W["C"], W["jac"], W["jx"], W["jy"]
    wx, wdx, wy, wdy, wt = W["wphi_x"], W["wdphi_x"], W["wphi_y"], W["wdphi_y"], W["wphi_t"]
    shape = ux.shape
    Pm = (Pjx[:, None] * Pky[None]).reshape((-1,) + shape)
    dxm = (dPjx[:, None] * Pky[None]).reshape((-1,) + shape)
    dym = (Pjx[:, None] * dPky[None]).reshape((-1,) + shape)
    return jac * C(wx, wy, wt, dxm * ux + dym * uy) + jx * C(wdx, wy, wt, Pm * ux) + jy * C(wx, wdy, wt, Pm * uy)


def fit_epsilon_field2d(
    problem, params, order_x: int = 5, order_y: int = 5,
    reg: float = 1e-8, u_fn=None,
):
    """2D diffusivity-MAP recovery: the advdiff2d form-1 weak residual is
    AFFINE in eps(x, y), so a tensor-Legendre expansion
    eps = sum_jk c_jk P_j(x) P_k(y) is one column-equilibrated lstsq at the
    frozen solution: the 2-space-dimension twin of fit_epsilon_field.

    Returns (coef [order_x, order_y], eps_fn(x, y), info).
    """
    if problem.name != "advdiff2d":
        raise ValueError(f"fit_epsilon_field2d supports advdiff2d problems, got {problem.name!r}")
    cfg = problem.config
    el = problem.data["elements"]

    if u_fn is None:
        u_fn = lambda X: problem.apply(params, X)  # noqa: E731
    with torch.no_grad():
        flds = scalar_fields_3d(u_fn, el.x, el.y, el.z, second=False)
        vx, vy = (float(host(v)) for v in problem.extras["v_of"](params))
    ut, ux, uy = flds["uz"], flds["ux"], flds["uy"]

    W = _weak_fit_arrays_3d(problem)
    on, mask = W["on"], W["mask"]
    (ax_, bx_), (ay_, by_) = cfg.domain_x, cfg.domain_y
    hx, hy = (bx_ - ax_) / 2.0, (by_ - ay_) / 2.0
    Px, dPx = (on(a) for a in _legendre_grid(order_x, (W["x"] - (ax_ + bx_) / 2.0) / hx, hx))
    Py, dPy = (on(a) for a in _legendre_grid(order_y, (W["y"] - (ay_ + by_) / 2.0) / hy, hy))

    b_flat = host((W["f_proj"] - W["jac"] * W["C"](W["wphi_x"], W["wphi_y"], W["wphi_t"], ut + vx * ux + vy * uy))
                  * mask).reshape(-1)
    A = _columns(_eps2d_columns(W, Px, dPx, Py, dPy, ux, uy), mask)
    coef = _lstsq_equilibrated(A, b_flat, reg).reshape(order_x, order_y)

    def eps_fn(X, Y):
        xi_p = (np.asarray(X, dtype=np.float64) - (ax_ + bx_) / 2.0) / hx
        et_p = (np.asarray(Y, dtype=np.float64) - (ay_ + by_) / 2.0) / hy
        Pj = np.asarray(jacobi_all(order_x - 1, 0.0, 0.0, xi_p.reshape(-1)))
        Pk = np.asarray(jacobi_all(order_y - 1, 0.0, 0.0, et_p.reshape(-1)))
        return np.einsum("jk,jp,kp->p", coef, Pj, Pk).reshape(np.shape(X))

    info = {
        "residual_before": float(np.linalg.norm(b_flat)),
        "residual_after": float(np.linalg.norm(A @ coef.reshape(-1) - b_flat)),
        "order_x": order_x,
        "order_y": order_y,
    }
    return coef, eps_fn, info


def als_identify2d(
    problem,
    space_order: int = 10,
    time_order: int = 8,
    eps_order: int = 5,
    w_data: float = 10.0,
    eps_reg: float = 1e-8,
    iters: int = 6,
    eps_init: float = 0.1,
):
    """Network-free alternating-linear identification of a 2D diffusivity
    MAP eps(x, y): u in a global spectral tensor basis (boundary-vanishing
    bubbles in x and y, Legendre in t) is LINEAR given the map; the map's
    tensor-Legendre coefficients are LINEAR given u (fit_epsilon_field2d's
    system).  Two alternating lstsq solves per round: the 2-space-
    dimension twin of als_identify, for the clean dense-data regime.

    SIZE RULE (measured in the JAX package): the problem's test orders must
    EXCEED the u-basis orders (n_test_* > space_order/time_order) or the
    u-solve is rank-deficient and the iteration diverges.

    Returns (u_fn, coef [eps_order, eps_order], eps_fn(x, y), info).
    """
    from hpvpinns_tpu_torch.spectral.basis import make_test_basis

    if problem.name != "advdiff2d":
        raise ValueError(f"als_identify2d supports advdiff2d problems, got {problem.name!r}")
    if getattr(problem.config, "velocity_trainable", False):
        warnings.warn(
            "als_identify2d treats (vx, vy) as KNOWN but this problem has "
            "velocity_trainable=True: the values used are velocity_init "
            f"({problem.config.velocity_init}), not the truth. Identify "
            "coefficients jointly with reduced_identify2d instead.",
            stacklevel=2,
        )
    cfg = problem.config
    T = cfg.t_final
    (ax_, bx_d), (ay_, by_d) = cfg.domain_x, cfg.domain_y
    hx, hy = (bx_d - ax_) / 2.0, (by_d - ay_) / 2.0

    W = _weak_fit_arrays_3d(problem)
    on, mask, C, jac, jx, jy = W["on"], W["mask"], W["C"], W["jac"], W["jx"], W["jy"]
    wx, wdx, wy, wdy, wt = W["wphi_x"], W["wdphi_x"], W["wphi_y"], W["wdphi_y"], W["wphi_t"]
    x_g, y_g, t_g = W["x"], W["y"], W["t"]  # [E, Qt, Qy, Qx]
    shape = x_g.shape

    def sb(v, h, center):
        xi = (np.asarray(v, dtype=np.float64).reshape(-1) - center) / h
        tb = make_test_basis(space_order, xi)
        return np.asarray(tb.phi), np.asarray(tb.dphi) / h

    def tb_(t):
        tau = 2.0 * np.asarray(t, dtype=np.float64).reshape(-1) / T - 1.0
        P = np.asarray(jacobi_all(time_order - 1, 0.0, 0.0, tau))
        dP = np.stack([djacobi(m, 0.0, 0.0, tau, 1) * 2.0 / T for m in range(time_order)])
        return P, dP

    PHX, dPHX = (a.reshape((space_order,) + shape) for a in sb(x_g, hx, (ax_ + bx_d) / 2))
    PHY, dPHY = (a.reshape((space_order,) + shape) for a in sb(y_g, hy, (ay_ + by_d) / 2))
    PST, dPST = (a.reshape((time_order,) + shape) for a in tb_(t_g))

    with torch.no_grad():
        vx, vy = (float(host(v)) for v in problem.extras["v_of"](_known_velocity_params(problem)))
    b_weak = host(W["f_proj"] * mask).reshape(-1)
    n_c = space_order * space_order * time_order

    Xb = host(problem.data["xb"])
    ub = host(problem.data["ub"]).reshape(-1)
    Psx, _ = sb(Xb[:, 0], hx, (ax_ + bx_d) / 2)
    Psy, _ = sb(Xb[:, 1], hy, (ay_ + by_d) / 2)
    Pst, _ = tb_(Xb[:, 2])
    B_data = (Psx[:, None, None, :] * Psy[None, :, None, :] * Pst[None, None, :, :]).reshape(n_c, -1).T

    # tensor-Legendre map basis at the quadrature grid
    Pjx, dPjx = _legendre_grid(eps_order, (x_g - (ax_ + bx_d) / 2.0) / hx, hx)
    Pky, dPky = _legendre_grid(eps_order, (y_g - (ay_ + by_d) / 2.0) / hy, hy)
    map_basis = [on(a) for a in (Pjx, dPjx, Pky, dPky)]

    def eps_grid(coef, a, b):
        return np.einsum("jk,j...,k...->...", coef, a, b)

    PHX_d, dPHX_d, PHY_d, dPHY_d, PST_d, dPST_d = (on(a) for a in (PHX, dPHX, PHY, dPHY, PST, dPST))

    def u_solve(e_q, ex_q, ey_q):
        e_q, ex_q, ey_q = on(e_q), on(ex_q), on(ey_q)
        blocks = []
        for i in range(space_order):  # columns (i, j, m), k = (i * S + j) * M + m, a block per i
            ut_b = PHX_d[i] * PHY_d[:, None] * dPST_d[None]
            ux_b = dPHX_d[i] * PHY_d[:, None] * PST_d[None]
            uy_b = PHX_d[i] * dPHY_d[:, None] * PST_d[None]
            r = (
                jac * C(wx, wy, wt, ut_b + (vx + ex_q) * ux_b + (vy + ey_q) * uy_b)
                + jx * C(wdx, wy, wt, e_q * ux_b)
                + jy * C(wx, wdy, wt, e_q * uy_b)
            )
            blocks.append(_columns(r.reshape((-1,) + r.shape[2:]), mask))
        A_full = np.vstack([np.hstack(blocks), w_data * B_data])
        b_full = np.concatenate([b_weak, w_data * ub])
        c, *_ = np.linalg.lstsq(A_full, b_full, rcond=None)
        return c

    def eps_solve(c):
        cm = c.reshape(space_order, space_order, time_order)
        ut = on(np.einsum("ijm,i...,j...,m...->...", cm, PHX, PHY, dPST))
        ux = on(np.einsum("ijm,i...,j...,m...->...", cm, dPHX, PHY, PST))
        uy = on(np.einsum("ijm,i...,j...,m...->...", cm, PHX, dPHY, PST))
        b_vec = host((W["f_proj"] - jac * C(wx, wy, wt, ut + vx * ux + vy * uy)) * mask)
        A = _columns(_eps2d_columns(W, *map_basis, ux, uy), mask)
        return _lstsq_equilibrated(A, b_vec, eps_reg).reshape(eps_order, eps_order)

    coef = np.zeros((eps_order, eps_order))
    coef[0, 0] = eps_init
    c = None
    for _ in range(iters):
        c = u_solve(eps_grid(coef, Pjx, Pky), eps_grid(coef, dPjx, Pky), eps_grid(coef, Pjx, dPky))
        coef = eps_solve(c)

    cm = c.reshape(space_order, space_order, time_order)

    def u_fn(X):
        X = np.asarray(X, dtype=np.float64)
        Px, _ = sb(X[:, 0], hx, (ax_ + bx_d) / 2)
        Py, _ = sb(X[:, 1], hy, (ay_ + by_d) / 2)
        Pt, _ = tb_(X[:, 2])
        return np.einsum("ijm,ip,jp,mp->p", cm, Px, Py, Pt).reshape(-1, 1)

    def eps_fn(X, Y):
        xi = (np.asarray(X, dtype=np.float64) - (ax_ + bx_d) / 2.0) / hx
        et = (np.asarray(Y, dtype=np.float64) - (ay_ + by_d) / 2.0) / hy
        Pj = np.asarray(jacobi_all(eps_order - 1, 0.0, 0.0, xi.reshape(-1)))
        Pk = np.asarray(jacobi_all(eps_order - 1, 0.0, 0.0, et.reshape(-1)))
        return np.einsum("jk,jp,kp->p", coef, Pj, Pk).reshape(np.shape(X))

    return u_fn, coef, eps_fn, {"space_order": space_order, "time_order": time_order}


def _own_sensors(problem, sample):
    """(Xs, ds) of a Navier-Stokes or Helmholtz inverse problem: the
    problem's own sensor data (data["xs"], data["us"]) as float64 numpy when
    present, else `sample()`."""
    if "xs" in problem.data:
        return host(problem.data["xs"]), host(problem.data["us"])
    return sample()


def reduced_identify_kovasznay(
    problem,
    p: int = 16,
    bounds=(5e-3, 0.2),
    xatol: float = 1e-12,
    noise: float = 0.0,
    seed: int = 0,
):
    """VISCOSITY identification for the Navier-Stokes SYSTEM: Brent-search
    nu with the steady spectral solver (galerkin.solve_ns_steady) in the
    loop, minimizing the misfit against interior (u, v) velocity sensors.
    Each trial solve warm-starts Newton from the previous solution.

    Sensors come from the problem's own inverse-mode data when present,
    else are LHS-sampled here (seeded; `noise` adds Gaussian
    perturbation).  Boundary data for the solver is the Kovasznay trace.

    Returns (nu_hat, info).
    """
    from scipy.optimize import minimize_scalar

    from hpvpinns_tpu_torch.galerkin import solve_ns_steady
    from hpvpinns_tpu_torch.problems.kovasznay import exact_fields
    from hpvpinns_tpu_torch.utils.sampling import lhs_interval

    if problem.name != "kovasznay":
        raise ValueError(f"reduced_identify_kovasznay supports kovasznay problems, got {problem.name!r}")
    cfg = problem.config

    def sample():
        rng = np.random.default_rng(seed)
        xs = lhs_interval(*cfg.domain_x, cfg.n_sensors, rng)
        ys = lhs_interval(*cfg.domain_y, cfg.n_sensors, rng)
        Xs = np.hstack([xs, ys])
        u, v, _ = exact_fields(Xs[:, 0], Xs[:, 1], cfg.re)
        ds = np.stack([u, v], axis=-1)
        if noise > 0.0:
            ds = ds + rng.normal(0.0, noise, ds.shape)
        return Xs, ds

    Xs, ds = _own_sensors(problem, sample)

    def g_fn(x, y):
        u, v, _ = exact_fields(x, y, cfg.re)
        return u, v

    n_solves = [0]
    warm = {"c": None}

    def misfit(nu):
        sol = solve_ns_steady(cfg.domain_x, cfg.domain_y, p, float(nu), g_fn, start=warm["c"])
        warm["c"] = np.concatenate([sol.coef_u.reshape(-1), sol.coef_v.reshape(-1), sol.coef_p.reshape(-1)[1:]])
        n_solves[0] += 1
        u, v = sol.velocity(Xs[:, 0], Xs[:, 1])
        return float(np.sum((u - ds[:, 0]) ** 2 + (v - ds[:, 1]) ** 2))

    res = minimize_scalar(misfit, bounds=bounds, method="bounded", options={"xatol": xatol})
    return float(res.x), {
        "misfit": float(res.fun), "n_solves": n_solves[0],
        "n_sensors": len(ds), "method": "brent-bounded", "p": p,
    }


def reduced_identify_taylorgreen(
    problem,
    p: int = 10,
    n_steps: int = 60,
    bounds=(0.01, 0.5),
    xatol: float = 1e-12,
    noise: float = 0.0,
    seed: int = 0,
):
    """VISCOSITY identification for the UNSTEADY Navier-Stokes system:
    Brent-search nu with the BDF2 spectral solver
    (galerkin.solve_ns_unsteady) in the loop, minimizing the misfit against
    interior space-time (u, v) sensors.

    Sensors come from the problem's own inverse-mode data when present,
    else are LHS-sampled here.

    Returns (nu_hat, info).
    """
    from scipy.optimize import minimize_scalar

    from hpvpinns_tpu_torch.galerkin import solve_ns_unsteady
    from hpvpinns_tpu_torch.problems.taylorgreen import exact_fields
    from hpvpinns_tpu_torch.utils.sampling import lhs_box

    if problem.name != "taylorgreen":
        raise ValueError(f"reduced_identify_taylorgreen supports taylorgreen problems, got {problem.name!r}")
    cfg = problem.config

    def sample():
        rng = np.random.default_rng(seed)
        Xs = lhs_box([cfg.domain_x, cfg.domain_y, (0.0, cfg.t_final)], cfg.n_sensors, rng)
        u, v, _ = exact_fields(Xs[:, 0], Xs[:, 1], Xs[:, 2], cfg.re)
        ds = np.stack([u, v], axis=-1)
        if noise > 0.0:
            ds = ds + rng.normal(0.0, noise, ds.shape)
        return Xs, ds

    Xs, ds = _own_sensors(problem, sample)

    def g_fn(x, y, t):
        u, v, _ = exact_fields(x, y, t, cfg.re)
        return u, v

    def u0_fn(x, y):
        u, v, _ = exact_fields(x, y, 0.0, cfg.re)
        return u, v

    n_solves = [0]

    def misfit(nu):
        sol = solve_ns_unsteady(cfg.domain_x, cfg.domain_y, p, float(nu), g_fn, u0_fn, cfg.t_final, n_steps)
        n_solves[0] += 1
        u, v = sol.velocity(Xs[:, 0], Xs[:, 1], Xs[:, 2])
        return float(np.sum((u - ds[:, 0]) ** 2 + (v - ds[:, 1]) ** 2))

    res = minimize_scalar(misfit, bounds=bounds, method="bounded", options={"xatol": xatol})
    return float(res.x), {
        "misfit": float(res.fun), "n_solves": n_solves[0],
        "n_sensors": len(ds), "method": "brent-bounded",
        "p": p, "n_steps": n_steps,
    }


def reduced_identify_helmholtz(
    problem,
    p: int = 14,
    bounds=(40.0, 130.0),
    n_scan: int = 61,
    xatol: float = 1e-10,
    noise: float = 0.0,
    seed: int = 0,
):
    """WAVENUMBER identification for the Helmholtz family: search k^2 with
    the exact indefinite spectral solver (galerkin.solve_helmholtz2d) in
    the loop, minimizing the misfit against interior sensors.

    The misfit over k^2 has POLES at the discrete Dirichlet eigenvalues of
    the solver's pencil, so the route scans `n_scan` points over `bounds`
    first (skipping exactly singular solves) and Brent-refines inside the
    bracketing interval of the scan minimum.

    Sensors come from the problem's own inverse-mode data when present,
    else are LHS-sampled here (seeded; `noise` adds Gaussian perturbation).
    Boundary data for the solver is the exact trace via the Coons
    interpolant.

    Returns (k_sq_hat, info).
    """
    from scipy.optimize import minimize_scalar

    from hpvpinns_tpu_torch.galerkin import coons_lift, solve_helmholtz2d
    from hpvpinns_tpu_torch.utils.sampling import lhs_box

    if problem.name != "helmholtz2d":
        raise ValueError(f"reduced_identify_helmholtz supports helmholtz2d problems, got {problem.name!r}")
    cfg = problem.config

    def sample():
        rng = np.random.default_rng(seed)
        Xs = lhs_box([cfg.domain_x, cfg.domain_y], cfg.n_sensors, rng)
        ds = np.asarray(problem.exact(Xs[:, 0:1], Xs[:, 1:2])).reshape(-1)
        if noise > 0.0:
            ds = ds + rng.normal(0.0, noise, ds.shape)
        return Xs, ds

    Xs, ds = _own_sensors(problem, sample)
    ds = ds.reshape(-1)

    mesh = problem.extras["mesh"]
    f_fn = problem.extras["f_rhs"]
    lift = coons_lift(problem.exact, cfg.domain_x, cfg.domain_y)
    n_solves = [0]

    def misfit(k_sq):
        try:
            sol = solve_helmholtz2d(mesh, p, float(k_sq), f_fn, lift_fn=lift)
        except np.linalg.LinAlgError:  # exactly singular: at a resonance
            return np.inf
        n_solves[0] += 1
        u = sol(Xs[:, 0], Xs[:, 1]).reshape(-1)
        return float(np.sum((u - ds) ** 2))

    grid = np.linspace(bounds[0], bounds[1], n_scan)
    vals = np.array([misfit(g) for g in grid])
    i = int(np.argmin(vals))
    lo = grid[max(i - 1, 0)]
    hi = grid[min(i + 1, n_scan - 1)]

    res = minimize_scalar(misfit, bounds=(lo, hi), method="bounded", options={"xatol": xatol})
    return float(res.x), {
        "misfit": float(res.fun), "n_solves": n_solves[0],
        "n_sensors": len(ds), "method": "scan+brent-bounded", "p": p,
        "scan_bracket": (float(lo), float(hi)),
    }
