"""Uncertainty quantification for the inverse-identification suite.

Counterpart of hpvpinns_tpu/uncertainty.py, with the same names, signatures
and returns.  Every route in inverse.py returns a point estimate; this
module attaches error bars:

  * **Linear routes** (fit_epsilon_field / fit_coefficient_fields / the ALS
    eps-solve): the estimate is a least-squares solve c = argmin||Ac - b||^2
    (+ Tikhonov), so the classical closed-form covariance applies:
    Cov = sigma^2 (A'A + G)^{-1} A'A (A'A + G)^{-1} with the residual-based
    noise estimate sigma^2 = RSS / (rows - dof).  The delta method maps
    coefficient covariance to a pointwise field band.
  * **Reduced routes** (Brent / Nelder-Mead over exact forward solves, and
    the differentiable log-field route): nonlinear least squares, so the
    Gauss-Newton/Fisher approximation Cov = sigma^2 (S'S)^{-1} with the
    sensor sensitivity S = d(pred)/d(theta): by central finite differences
    of the forward solver for the scalar/(eps, V) routes, by the EXACT
    forward-mode Jacobian (torch.func.jacfwd, on the problem's device) of the
    exposed `predict` closure for the field route.  With known sensor noise
    the same S'S gives the Cramer-Rao lower bound.
  * **ALS**: no single linear system owns the estimate (u and eps alternate),
    so a residual bootstrap over the sensor rows re-runs the whole
    alternation B times (numpy default_rng(seed): the JAX package's draws).

Caveat: the linear-route "noise" is the frozen-u approximation error, which
is neither iid nor mean-zero across weak rows, so the closed-form band is an
approximation whose calibration the JAX package measured rather than
assumed.  Everything but the field route's Jacobian is host float64
numpy/scipy, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.inverse import exact_initial, host, interior_sensors
from hpvpinns_tpu_torch.spectral.jacobi import jacobi_all


def lstsq_covariance(A: np.ndarray, b: np.ndarray, coef: np.ndarray,
                     reg_gram: Optional[np.ndarray] = None):
    """Covariance of a (possibly Tikhonov-regularized) lstsq estimate.

    A [M, J], b [M], coef [J] = the solution that was actually returned;
    reg_gram = the lam * L'L matrix added to the normal equations (None for
    plain lstsq).  Returns (cov [J, J], sigma2).
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    coef = np.asarray(coef, dtype=np.float64).reshape(-1)
    M, J = A.shape
    resid = A @ coef - b
    sigma2 = float(resid @ resid) / max(M - J, 1)
    AtA = A.T @ A
    H = AtA if reg_gram is None else AtA + np.asarray(reg_gram, dtype=np.float64)
    Hinv = np.linalg.pinv(H)
    return sigma2 * (Hinv @ AtA @ Hinv), sigma2


def legendre_field_band(coef: np.ndarray, cov: np.ndarray, domain=(-1.0, 1.0)):
    """Delta-method pointwise std of eps(x) = sum_j c_j P_j(xi(x)).

    Returns std_fn(x) -> same-shape array of 1-sigma field uncertainties.
    """
    coef = np.asarray(coef, dtype=np.float64)
    cov = np.asarray(cov, dtype=np.float64)
    a, b = domain
    half = (b - a) / 2.0

    def std_fn(x):
        x = np.asarray(x, dtype=np.float64)
        xi = (x.reshape(-1) - (a + b) / 2.0) / half
        P = np.asarray(jacobi_all(len(coef) - 1, 0.0, 0.0, xi))  # [J, P]
        var = np.einsum("jp,jk,kp->p", P, cov, P)
        return np.sqrt(np.maximum(var, 0.0)).reshape(np.shape(x))

    return std_fn


def _gauss_newton_ci(predict, theta, ds, names, rel_step: float, noise_std: Optional[float]):
    """The Gauss-Newton interval shared by the finite-difference routes:
    S by central differences of predict (2 solves a parameter), sigma^2
    from the residuals at theta unless the true `noise_std` is given (the
    CRLB).  Returns the reduced_scalar_ci dict."""
    resid = predict(theta) - ds
    n, k = len(ds), len(theta)
    cols = []
    for i in range(k):
        h = rel_step * max(abs(theta[i]), 1e-8)
        tp, tm = list(theta), list(theta)
        tp[i] += h
        tm[i] -= h
        cols.append((predict(tp) - predict(tm)) / (2 * h))
    S = np.stack(cols, axis=1)  # [n, k]

    crlb = noise_std is not None
    sigma2 = noise_std**2 if crlb else float(resid @ resid) / max(n - k, 1)
    cov = sigma2 * np.linalg.pinv(S.T @ S)
    std = np.sqrt(np.maximum(np.diag(cov), 0.0))
    return {
        "params": names,
        "std": [float(s) for s in std],
        "ci95": [(float(t - 1.96 * s), float(t + 1.96 * s)) for t, s in zip(theta, std)],
        "sigma": float(np.sqrt(sigma2)),
        "n_sensors": n,
        "crlb": crlb,
    }


def reduced_scalar_ci(problem, coef, info=None, p: int = 40,
                      velocity: Optional[float] = None, rel_step: float = 1e-4,
                      noise_std: Optional[float] = None):
    """Gauss-Newton covariance for the scalar reduced routes.

    coef: the returned [1] epsilon (or pass velocity= for the joint (eps, V)
    route).  Sensitivities by central finite differences of the exact
    forward solver (2 solves per parameter).  sigma^2 from the residuals at
    the optimum unless the true sensor `noise_std` is given, in which case
    the returned interval is the Cramer-Rao bound at that noise level.

    Returns a dict: {"std": [..], "ci95": [(lo, hi), ..], "sigma": ...,
    "params": ["epsilon"(, "velocity")], "crlb": bool}.
    """
    from hpvpinns_tpu_torch.galerkin import solve_advdiff

    cfg = problem.config
    mesh = problem.extras["mesh"]
    vfn = problem.extras.get("velocity_fn")
    f_fn = problem.extras.get("f_rhs")
    Xs, ds = interior_sensors(problem)
    u0 = exact_initial(problem.exact)

    theta = [float(np.atleast_1d(coef)[0])]
    names = ["epsilon"]
    if velocity is not None:
        theta.append(float(velocity))
        names.append("velocity")

    def predict(th):
        vel = th[1] if len(th) > 1 else (vfn if vfn is not None else cfg.velocity)
        sol = solve_advdiff(mesh.axis_x, p, u0, th[0], vel, f_fn=f_fn)
        return np.asarray(sol(Xs[:, 0], Xs[:, 1]), dtype=np.float64).reshape(-1)

    return _gauss_newton_ci(predict, theta, ds, names, rel_step, noise_std)


def _predict2d_factory(problem, p: int):
    """(predict(theta [eps, vx, vy]) -> sensor predictions, ds) for the
    advdiff2d family: the same interior-sensor selection and exact
    tensor-product solver reduced_identify2d searches with."""
    from hpvpinns_tpu_torch.galerkin import solve_advdiff2d

    cfg = problem.config
    mesh = problem.extras["mesh"]
    exact = problem.exact
    f_fn = problem.extras.get("f_rhs")
    u0 = lambda X, Y: np.asarray(exact(X, Y, np.zeros_like(X)))  # noqa: E731

    Xs, ds = interior_sensors(problem, dims=2)
    if Xs.shape[0] == 0:
        raise ValueError("problem has no interior sensors — nothing to bound")

    def predict(th):
        vx_c = th[1] if len(th) > 1 else cfg.velocity[0]
        vy_c = th[2] if len(th) > 2 else cfg.velocity[1]
        sol = solve_advdiff2d(mesh.axis_x, mesh.axis_y, p, u0, th[0], vx_c, vy_c, f_fn=f_fn)
        return np.asarray(sol(Xs[:, 0], Xs[:, 1], Xs[:, 2]), dtype=np.float64).reshape(-1)

    return predict, ds


def reduced_scalar_ci2d(problem, coef, p: int = 12, rel_step: float = 1e-4,
                        noise_std: Optional[float] = None):
    """Gauss-Newton covariance for the 2D reduced route (eps, vx, vy).

    Same contract as reduced_scalar_ci, for the advdiff2d family: central
    finite differences of the exact tensor-product forward solver
    (galerkin.solve_advdiff2d, the same solver reduced_identify2d searches
    with) at the interior (x, y, t) sensors: 2 solves per parameter plus
    one at the estimate.  sigma^2 from the residuals at the optimum unless
    the true sensor `noise_std` is given (then the interval is the CRLB at
    that level).  The JAX package measured the epsilon interval
    anti-conservative (~60% at 95% nominal, 25 sensors) and the velocity
    intervals exact; the CRLB mode calibrates markedly better."""
    predict, ds = _predict2d_factory(problem, p)
    theta = [float(v) for v in np.atleast_1d(np.asarray(coef, dtype=np.float64))]
    return _gauss_newton_ci(predict, theta, ds, ["epsilon", "vx", "vy"][: len(theta)], rel_step, noise_std)


def profile_eps_ci2d(problem, coef, p: int = 12,
                     noise_std: Optional[float] = None,
                     chi2_1: float = 3.841, max_expand: int = 10):
    """Profile-likelihood 95% interval for epsilon on the 2D reduced route:
    inverts the likelihood-ratio test instead of linearizing,

        eps in CI  <=>  min_{vx,vy} ||r(eps, vx, vy)||^2
                          <= ||r(theta_hat)||^2 + sigma^2 chi2_{1,95%}

    The inner minimization is a warm-started Nelder-Mead over (vx, vy)
    with the exact tensor solver; the boundary is found by stepping
    outward in linearized-std units then bisecting.  sigma^2 from the
    residuals at the optimum unless `noise_std` is given.

    Returns {"eps_ci95": (lo, hi), "sigma", "misfit_min", "n_profile"}.
    """
    from scipy.optimize import minimize

    predict, ds = _predict2d_factory(problem, p)
    theta = np.asarray(coef, dtype=np.float64)
    if theta.size != 3:
        raise ValueError("profile_eps_ci2d needs the full (eps, vx, vy) estimate")

    n_eval = [0]

    def sse(th):
        n_eval[0] += 1
        r = predict(th) - ds
        return float(r @ r)

    f_min = sse(theta)
    n, k = len(ds), 3
    sigma2 = noise_std**2 if noise_std is not None else f_min / max(n - k, 1)
    thresh = f_min + sigma2 * chi2_1

    # linearized eps std as the step unit (2 extra solves)
    h = 1e-4 * max(abs(theta[0]), 1e-8)
    dpred = (predict([theta[0] + h, theta[1], theta[2]]) - predict([theta[0] - h, theta[1], theta[2]])) / (2 * h)
    n_eval[0] += 2
    step0 = float(np.sqrt(sigma2 / max(dpred @ dpred, 1e-300)))

    def g(eps, warm):
        """Profile misfit at fixed eps (inner NM over the velocities)."""
        res = minimize(
            lambda v: sse([eps, v[0], v[1]]), np.asarray(warm),
            method="Nelder-Mead",
            options={"xatol": 1e-8, "fatol": 1e-2 * sigma2, "maxiter": 80},
        )
        return float(res.fun), res.x

    def boundary(direction):
        lo_e, warm = float(theta[0]), theta[1:].copy()
        step = step0
        hi_e = None
        for _ in range(max_expand):
            cand = lo_e + direction * step
            if cand <= 0:
                cand = 1e-8 if direction < 0 else cand
            g_c, warm_c = g(cand, warm)
            if g_c > thresh:
                hi_e = cand
                break
            lo_e, warm = cand, warm_c
            step *= 1.6
            if cand <= 1e-8 and direction < 0:
                return 0.0  # positivity-truncated
        if hi_e is None:
            return lo_e  # never crossed within max_expand steps
        for _ in range(8):  # bisect
            mid = 0.5 * (lo_e + hi_e)
            g_m, warm_m = g(mid, warm)
            if g_m > thresh:
                hi_e = mid
            else:
                lo_e, warm = mid, warm_m
        return 0.5 * (lo_e + hi_e)

    lo = boundary(-1.0)
    hi = boundary(+1.0)
    return {
        "eps_ci95": (float(lo), float(hi)),
        "sigma": float(np.sqrt(sigma2)),
        "misfit_min": f_min,
        "n_profile": n_eval[0],
    }


def reduced_field_ci(s_coef, info, domain=(-1.0, 1.0),
                     noise_std: Optional[float] = None):
    """Fisher/CRLB covariance of the differentiable log-field route.

    Uses the EXACT forward-mode Jacobian (torch.func.jacfwd, on the device
    the closure lives on) of the sensor-prediction closure that
    reduced_identify_field exposes as info["predict"].  The log-field
    covariance maps to a pointwise eps(x) band by the delta method
    (d eps / d s_j = eps(x) P_j(x)).

    Returns {"cov_s", "sigma", "std_fn", "crlb"}.
    """
    predict = info["predict"]
    ds = np.asarray(info["sensor_values"], dtype=np.float64)
    s_coef = np.asarray(s_coef, dtype=np.float64)
    with torch.no_grad():
        pred0 = predict(s_coef)  # on the device the closure lives on
        S = host(torch.func.jacfwd(predict)(torch.as_tensor(s_coef).to(pred0.device)))
    pred0 = host(pred0)
    n, k = S.shape
    crlb = noise_std is not None
    resid = pred0 - ds
    sigma2 = noise_std**2 if crlb else float(resid @ resid) / max(n - k, 1)
    cov_s = sigma2 * np.linalg.pinv(S.T @ S)

    a, b = domain
    half = (b - a) / 2.0

    def std_fn(x):
        x = np.asarray(x, dtype=np.float64)
        xi = (x.reshape(-1) - (a + b) / 2.0) / half
        P = np.asarray(jacobi_all(len(s_coef) - 1, 0.0, 0.0, xi))  # [J, P]
        eps = np.exp(P.T @ s_coef)
        var = eps**2 * np.einsum("jp,jk,kp->p", P, cov_s, P)
        return np.sqrt(np.maximum(var, 0.0)).reshape(np.shape(x))

    return {"cov_s": cov_s, "sigma": float(np.sqrt(sigma2)), "std_fn": std_fn,
            "n_sensors": n, "crlb": crlb}


def als_bootstrap(problem, eps_coef, u_fn, n_boot: int = 16, seed: int = 0,
                  **als_kwargs):
    """Residual bootstrap for the ALS field estimate.

    The sensor residuals of the recovered solution are recentred and
    resampled onto the sensor readings; the FULL alternation re-runs per
    replicate.  Returns {"coef_samples" [B, J], "coef_std" [J], "std_fn"}
    with the percentile-free (sample-std) field band.
    """
    from hpvpinns_tpu_torch.inverse import als_identify, legendre_field

    rng = np.random.default_rng(seed)
    cfg = problem.config
    ub_t = problem.data["ub"]
    Xb = host(problem.data["xb"])
    ub = host(ub_t).reshape(-1)
    a_dom, b_dom = cfg.domain_x
    sel = (Xb[:, 1] > 1e-12) & (Xb[:, 0] > a_dom + 1e-12) & (Xb[:, 0] < b_dom - 1e-12)
    pred_s = np.asarray(u_fn(Xb[sel])).reshape(-1)
    resid = ub[sel] - pred_s
    resid = resid - resid.mean()

    samples = []
    for _ in range(n_boot):
        ub_b = ub.copy()
        ub_b[sel] = pred_s + rng.choice(resid, size=resid.size, replace=True)
        data_b = dict(problem.data)
        data_b["ub"] = torch.as_tensor(ub_b.reshape(ub_t.shape)).to(device=ub_t.device, dtype=ub_t.dtype)
        _, coef_b, _, _ = als_identify(_with_data(problem, data_b), **als_kwargs)
        samples.append(coef_b)
    samples = np.stack(samples)
    coef_std = samples.std(axis=0, ddof=1)

    def std_fn(x):
        x = np.asarray(x, dtype=np.float64)
        vals = np.stack([np.asarray(legendre_field(s, cfg.domain_x)(x)).reshape(-1) for s in samples])
        return vals.std(axis=0, ddof=1).reshape(np.shape(x))

    return {"coef_samples": samples, "coef_std": coef_std, "std_fn": std_fn, "n_boot": n_boot}


def _with_data(problem, data):
    """Shallow Problem copy with replaced data."""
    return dataclasses.replace(problem, data=data)


def _scalar_gn_ci(predict, theta_hat: float, ds, name: str, rel_step: float, noise_std: Optional[float]):
    """The one-parameter Gauss-Newton interval of the Navier-Stokes and
    Helmholtz routes: (the prediction at theta_hat, S, the dict without
    ci95), S by central differences (2 solves) and sigma^2 = RSS / (n - 1)
    or noise_std^2."""
    pred = predict(theta_hat)
    resid = pred - ds
    h = rel_step * max(abs(theta_hat), 1e-8)
    S = (predict(theta_hat + h) - predict(theta_hat - h)) / (2 * h)
    n = len(ds)
    crlb = noise_std is not None
    sigma2 = noise_std**2 if crlb else float(resid @ resid) / max(n - 1, 1)
    std = float(np.sqrt(max(sigma2 / float(S @ S), 0.0)))
    return pred, S, {"params": [name], "std": [std], "sigma": float(np.sqrt(sigma2)), "n_sensors": n, "crlb": crlb}


def reduced_ns_ci(problem, nu_hat: float, p: int = 16, rel_step: float = 1e-4,
                  noise_std: Optional[float] = None):
    """Gauss-Newton covariance for the Navier-Stokes viscosity route
    (inverse.reduced_identify_kovasznay): sensitivity of the interior
    (u, v) sensor predictions to nu by central differences of the steady
    spectral solver (2 warm-started solves), sigma^2 from the residuals at
    the optimum, or the CRLB at a declared `noise_std`.

    Returns the reduced_scalar_ci dict shape: {"params": ["nu"], "std",
    "ci95", "sigma", "n_sensors", "crlb"}.
    """
    from hpvpinns_tpu_torch.galerkin import solve_ns_steady
    from hpvpinns_tpu_torch.problems.kovasznay import exact_fields

    cfg = problem.config
    Xs = host(problem.data["xs"])
    ds = host(problem.data["us"]).reshape(-1)

    def g_fn(x, y):
        u, v, _ = exact_fields(x, y, cfg.re)
        return u, v

    warm = {"c": None}

    def predict(nu):
        sol = solve_ns_steady(cfg.domain_x, cfg.domain_y, p, float(nu), g_fn, start=warm["c"])
        warm["c"] = np.concatenate([sol.coef_u.reshape(-1), sol.coef_v.reshape(-1), sol.coef_p.reshape(-1)[1:]])
        u, v = sol.velocity(Xs[:, 0], Xs[:, 1])
        return np.stack([u, v], axis=-1).reshape(-1)

    _, _, out = _scalar_gn_ci(predict, nu_hat, ds, "nu", rel_step, noise_std)
    std = out["std"][0]
    return {**out, "ci95": [(float(nu_hat - 1.96 * std), float(nu_hat + 1.96 * std))]}


def reduced_ns_unsteady_ci(problem, nu_hat: float, p: int = 10,
                           n_steps: int = 60, rel_step: float = 1e-4,
                           noise_std: Optional[float] = None,
                           debias: bool = True):
    """Gauss-Newton covariance for the UNSTEADY Navier-Stokes viscosity
    route (inverse.reduced_identify_taylorgreen): sensitivity of the
    interior space-time (u, v) sensor predictions to nu by central
    differences of the BDF2 spectral solver (2 solves), sigma^2 from the
    residuals at the optimum, or the CRLB at a declared `noise_std`.

    This estimator's dominant error is the solver's O(dt^2) DISCRETIZATION
    BIAS, which no variance term prices.  `debias=True` removes it with ONE
    extra solve at 2*n_steps: Richardson-estimate the prediction's model
    error e ~ (4/3)(pred_n - pred_2n), map it through the GN normal
    equations (nu_hat - nu_true ~ -(S'e)/(S'S)) and recenter; the
    Richardson remainder is priced into the half-width as 0.25*|bias|.
    Keep (p, n_steps) matched to the identification call.

    Returns the reduced_scalar_ci dict shape plus, when debias is on,
    "bias" (the estimated nu_hat - nu_true) and "debiased" (the
    recentered estimate the ci95 is built around).
    """
    from hpvpinns_tpu_torch.galerkin import solve_ns_unsteady
    from hpvpinns_tpu_torch.problems.taylorgreen import exact_fields

    cfg = problem.config
    Xs = host(problem.data["xs"])
    ds = host(problem.data["us"]).reshape(-1)

    def g_fn(x, y, t):
        u, v, _ = exact_fields(x, y, t, cfg.re)
        return u, v

    def u0_fn(x, y):
        u, v, _ = exact_fields(x, y, 0.0, cfg.re)
        return u, v

    def predict(nu, steps=n_steps):
        sol = solve_ns_unsteady(cfg.domain_x, cfg.domain_y, p, float(nu), g_fn, u0_fn, cfg.t_final, steps)
        u, v = sol.velocity(Xs[:, 0], Xs[:, 1], Xs[:, 2])
        return np.stack([u, v], axis=-1).reshape(-1)

    pred, S, out = _scalar_gn_ci(predict, nu_hat, ds, "nu", rel_step, noise_std)
    std = out["std"][0]
    center, margin = nu_hat, 0.0
    if debias:
        e = (4.0 / 3.0) * (pred - predict(nu_hat, steps=2 * n_steps))
        bias = -float(S @ e) / float(S @ S)  # est. of nu_hat - nu_true
        center = nu_hat - bias
        margin = 0.25 * abs(bias)  # Richardson-remainder allowance
        out["bias"] = [bias]
        out["debiased"] = [float(center)]
    out["ci95"] = [(float(center - 1.96 * std - margin), float(center + 1.96 * std + margin))]
    return out


def reduced_helmholtz_ci(problem, k_sq_hat: float, p: int = 14,
                         rel_step: float = 1e-5,
                         noise_std: Optional[float] = None):
    """Gauss-Newton covariance for the Helmholtz wavenumber route
    (inverse.reduced_identify_helmholtz): sensitivity of the interior
    sensor predictions to k^2 by central differences of the indefinite
    spectral solver (2 solves), sigma^2 from the residuals at the optimum,
    or the CRLB at a declared `noise_std`.  Same dict shape as
    reduced_scalar_ci."""
    from hpvpinns_tpu_torch.galerkin import coons_lift, solve_helmholtz2d

    cfg = problem.config
    Xs = host(problem.data["xs"])
    ds = host(problem.data["us"]).reshape(-1)
    mesh = problem.extras["mesh"]
    f_fn = problem.extras["f_rhs"]
    lift = coons_lift(problem.exact, cfg.domain_x, cfg.domain_y)

    def predict(k_sq):
        sol = solve_helmholtz2d(mesh, p, float(k_sq), f_fn, lift_fn=lift)
        return sol(Xs[:, 0], Xs[:, 1]).reshape(-1)

    _, _, out = _scalar_gn_ci(predict, k_sq_hat, ds, "k_sq", rel_step, noise_std)
    std = out["std"][0]
    return {**out, "ci95": [(float(k_sq_hat - 1.96 * std), float(k_sq_hat + 1.96 * std))]}
