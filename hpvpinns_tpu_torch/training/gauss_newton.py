"""Gauss-Newton / Levenberg-Marquardt on the VPINN residual vector.

Counterpart of hpvpinns_tpu/training/gauss_newton.py.  The hp-VPINN loss

    loss = sum_e mean_n Res[e, n]^2 + w_b * mean_b (u_b - u(x_b))^2 (+ reg)

is ||r(theta)||^2 for the stacked residual vector

    r = [ Res[e, n] / sqrt(n_test_e) ,  sqrt(w_b / N_b) * (u(x_b) - u_b) (, reg) ],

and Levenberg-Marquardt with Nielsen's gain-ratio control minimizes it over
theta, the flat parameter vector in the JAX package's ravel_pytree order
(`problems/base.py::parameters`), so the columns of J = dr/dtheta [M, P] are
the JAX package's.

J is built by forward mode (a vmap of JVPs over the P parameter directions)
when P <= M, else by reverse mode (a vmap of VJPs over the M residuals),
whole or in blocks of `jac_chunk`.  Under deriv_mode="pallas" the reverse
build runs B2 once for each cotangent (ops/fused_fields.py::_FieldsFlatVjp);
the forward build and the matrix-free "cg"/"lsqr" solves need a JVP, which
the kernels do not have (as the JAX package's custom_vjp has none): they
raise a TypeError that says so.

The damped step has five solves, each returning (delta, the predicted
decrease of the undamped model, |J^T r|_inf): "normal" (the damped normal
equations by Cholesky, on the primal or, when M < P, the dual system),
"qr" (the reduced QR of [J; sqrt(lam) I]), "host" (the normal equations in
float64: the JAX package pulls r and J to the host for it; here it runs on
the device, which has float64; a failed factorization or a J that is not
finite rejects the step), and the matrix-free "cg" and "lsqr".  CG and LSQR
loop in Python with one host read of the stopping test an iteration, and
stop at the iteration JAX's `lax.while_loop` stops at.  `cg_precond` draws
its Rademacher probes from a torch.Generator seeded 17, not from
`jax.random.key(17)`: a difference by design (ROADMAP.md, queue C).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
from hpvpinns_tpu_torch.problems.base import map_params, parameters

SOLVES = ("normal", "host", "qr", "cg", "lsqr")


def make_residual_vector(problem) -> Callable:
    """(params, data) -> flat residual vector r with sum(r^2) == loss.

    Needs the problem's `extras["residual_fn"]` (the masked weak residual,
    element axis first) and takes `extras["reg_resvec_fn"]` for quadratic
    terms beyond it (AdvDiff's Tikhonov term, Helmholtz's sensor misfit,
    Burgers' strong collocation); a loss with terms outside both is caught
    by gauss_newton's identity check."""
    residual_fn = problem.extras.get("residual_fn")
    if residual_fn is None:
        raise ValueError(
            f"problem {problem.name!r} exposes no extras['residual_fn']; Gauss-Newton needs the weak-residual vector"
        )
    if getattr(problem.config, "scheme", "VPINNs") != "VPINNs":
        raise ValueError("Gauss-Newton supports the variational scheme only")
    reg_fn = problem.extras.get("reg_resvec_fn")
    wb = getattr(problem.config, "lossb_weight", 1.0)

    def resvec(params, data):
        el = data["elements"]
        res = residual_fn(params, data)  # masked, [E, ...]
        n_elem = res.shape[0]
        rv = (res.reshape(n_elem, -1) / torch.sqrt(el.n_test)[:, None]).reshape(-1)
        ub_pred = problem.apply(params, data["xb"])
        if ub_pred.dim() == 2 and ub_pred.shape[-1] != data["ub"].shape[-1]:
            # partial-state Dirichlet data: `ub` holds the leading components
            ub_pred = ub_pred[:, : data["ub"].shape[-1]]
        rb = np.sqrt(wb / data["ub"].numel()) * (ub_pred - data["ub"]).reshape(-1)
        parts = [rv, rb]
        if reg_fn is not None:
            parts.append(reg_fn(params, data).reshape(-1))
        return torch.cat(parts)

    return resvec


def ravel_params(params):
    """(theta, unravel): the leaves of `params` in `parameters` order (the
    JAX package's ravel_pytree order) as one flat detached copy, and the map
    from such a vector back to a params tree of views into it."""
    leaves = parameters(params)
    shapes, sizes = [t.shape for t in leaves], [t.numel() for t in leaves]
    index = {id(t): i for i, t in enumerate(leaves)}
    theta = torch.cat([t.detach().reshape(-1) for t in leaves])

    def unravel(vec):
        pieces = [p.view(s) for p, s in zip(torch.split(vec, sizes), shapes)]
        return map_params(lambda t: pieces[index[id(t)]], params)

    return theta, unravel


@dataclass
class GNResult:
    params: Any
    history: Dict[str, np.ndarray]
    iterations_run: int
    accepted: int
    wall_time_s: float
    stopped: str  # "iterations" | "gtol" | "ftol" | "damping"
    final_aux: Dict[str, float] = field(default_factory=dict)


def _aux_floats(aux) -> Dict[str, float]:
    keys = list(aux)
    return dict(zip(keys, torch.stack([aux[k].detach() for k in keys]).tolist()))  # one device sync


def _model_terms(r, J, delta):
    """The predicted squared-residual decrease of the undamped model and
    |J^T r|_inf."""
    pred = r + J @ delta
    return torch.sum(r * r) - torch.sum(pred * pred), torch.max(torch.abs(J.T @ r))


def _normal_delta(r, J, lam, dual: bool):
    """-argmin ||r + J d||^2 + lam ||d||^2 by a Cholesky factorization of the
    damped normal (primal) or dual system: (delta, info), info != 0 where it
    failed."""
    if dual:
        A = J @ J.T + lam * torch.eye(J.shape[0], dtype=J.dtype, device=J.device)
        L, info = torch.linalg.cholesky_ex(A)
        return -J.T @ torch.cholesky_solve(r[:, None], L)[:, 0], info
    A = J.T @ J + lam * torch.eye(J.shape[1], dtype=J.dtype, device=J.device)
    L, info = torch.linalg.cholesky_ex(A)
    return -torch.cholesky_solve((J.T @ r)[:, None], L)[:, 0], info


def _build_kernels(resvec, unravel, data, n_params: int, n_res: int, jac_chunk: Optional[int] = None,
                   cg_maxiter: Optional[int] = None, cg_tol: float = 1e-3, cg_precond: int = 0):
    """(r_and_J, loss_of, {solve name: step}) over the flat parameter vector.

    `jac_chunk` bounds the Jacobian build's memory: the min(M, P) vmapped
    JVP/VJP passes run in blocks of that many (torch.func.vmap's
    chunk_size).  None: all at once when min(M, P) <= 2048, else blocks of
    256, as in the JAX package."""

    def r_of(theta):
        return resvec(unravel(theta), data)

    fwd = n_params <= n_res
    n_pass = n_params if fwd else n_res
    if jac_chunk is None:
        jac_chunk = n_pass if n_pass <= 2048 else 256
    chunk = None if jac_chunk >= n_pass else jac_chunk

    def r_and_J(theta):
        eye = torch.eye(n_pass, dtype=theta.dtype, device=theta.device)
        if fwd:
            cols = torch.func.vmap(lambda v: torch.func.jvp(r_of, (theta,), (v,))[1], chunk_size=chunk)(eye)
            return r_of(theta).detach(), cols.T.detach()  # [M, P]
        r, vjp = torch.func.vjp(r_of, theta)
        return r.detach(), torch.func.vmap(lambda v: vjp(v)[0], chunk_size=chunk)(eye).detach()

    def loss_of(theta):
        with torch.no_grad():
            r = r_of(theta)
            return torch.sum(r * r)

    dual = n_res < n_params  # underdetermined: the min-norm step through J J^T

    def lm_step(r, J, lam):
        """The damped normal equations by Cholesky; a failed factorization
        gives a NaN step (rejected), as JAX's cho_factor does."""
        delta, info = _normal_delta(r, J, lam, dual)
        delta = torch.where(info == 0, delta, torch.full_like(delta, float("nan")))
        return (delta, *_model_terms(r, J, delta))

    def lm_step_qr(r, J, lam):
        """The damped step from the reduced QR of the augmented [J; sqrt(lam) I],
        backward-stable at cond(J) rather than cond(J)^2; no primal/dual
        branch (the damping block gives full column rank)."""
        p = J.shape[1]
        A = torch.cat([J, torch.sqrt(lam) * torch.eye(p, dtype=J.dtype, device=J.device)])
        b = torch.cat([r, torch.zeros(p, dtype=r.dtype, device=r.device)])
        q, R = torch.linalg.qr(A)
        delta = -torch.linalg.solve_triangular(R, (q.T @ b)[:, None], upper=True)[:, 0]
        return (delta, *_model_terms(r, J, delta))

    def lm_step_host(r, J, lam):
        """The normal equations in float64 (the JAX package's host solve, here
        on r's device).  A system that is not finite or a factorization that
        fails returns delta None, which the loop rejects."""
        r64, J64 = r.double(), J.double()
        if not bool(torch.isfinite(J64).all() & torch.isfinite(r64).all()):
            return None, 0.0, float("inf")
        delta, info = _normal_delta(r64, J64, lam.double(), dual)
        if int(info) != 0:
            return None, 0.0, float("inf")
        pred_dec, grad_inf = _model_terms(r64, J64, delta)
        return delta.to(r.dtype), float(pred_dec), float(grad_inf)

    # The iteration cap: n_params (the exact-arithmetic Krylov bound), at most 2000.
    max_cg = cg_maxiter if cg_maxiter is not None else min(n_params, 2000)

    def linear_maps(theta):
        """(r, J v, J^T u): the residual and its Jacobian products at theta."""
        r, vjp = torch.func.vjp(r_of, theta)

        def jvp_lin(v):
            return torch.func.jvp(r_of, (theta,), (v,))[1].detach()

        return r.detach(), jvp_lin, (lambda u: vjp(u)[0].detach())

    def lm_step_cg(theta, lam):
        """Matrix-free: CG on (J^T J + lam I) delta = -J^T r, J through JVPs
        and VJPs, stopped at ||A delta + g|| <= eta ||g|| with
        eta = min(cg_tol, ||g||) or at the iteration cap.  `cg_precond` > 0
        scales by the Hutchinson estimate of diag(J^T J) from that many
        Rademacher probes."""
        r, jvp_lin, vjp = linear_maps(theta)
        g = vjp(r)

        def matvec(v):
            return vjp(jvp_lin(v)) + lam * v

        minv = None
        if cg_precond > 0:
            gen = torch.Generator().manual_seed(17)
            zs = (2 * torch.randint(0, 2, (cg_precond, n_res), generator=gen) - 1).to(dtype=r.dtype, device=r.device)
            diag_est = torch.stack([vjp(z) ** 2 for z in zs]).mean(dim=0)
            minv = 1.0 / (diag_est + lam)

        def precond(v):
            return v if minv is None else minv * v

        b = -g
        rs0 = torch.dot(b, b)
        eta = torch.minimum(torch.as_tensor(cg_tol, dtype=rs0.dtype, device=rs0.device), torch.sqrt(rs0))
        tol2 = (eta * eta) * rs0
        x, rk, z0 = torch.zeros_like(g), b, precond(b)
        p, rz, rs, k = z0, torch.dot(b, z0), rs0, 0
        while k < max_cg and bool(rs > tol2):
            Ap = matvec(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            rk = rk - alpha * Ap
            zk = precond(rk)
            rz_new = torch.dot(rk, zk)
            p, rz, rs, k = zk + (rz_new / rz) * p, rz_new, torch.dot(rk, rk), k + 1
        pred = r + jvp_lin(x)
        return x, torch.sum(r * r) - torch.sum(pred * pred), torch.max(torch.abs(g)), k

    def lm_step_lsqr(theta, lam):
        """Matrix-free: damped LSQR (Paige and Saunders 1982), Golub-Kahan
        bidiagonalization of J through JVPs and VJPs, min ||J d + r||^2 +
        lam ||d||^2 without forming J^T J; stopped when its estimate of
        ||A_aug^T r_aug|| falls to eta ||J^T r|| (eta = min(cg_tol,
        sqrt(||J^T r||))) or at the iteration cap."""
        r, jvp_lin, vjp = linear_maps(theta)
        g = vjp(r)
        damp = torch.sqrt(lam)
        tiny = torch.as_tensor(1e-30, dtype=r.dtype, device=r.device)

        b = -r
        beta1 = torch.linalg.norm(b)
        u = b / torch.maximum(beta1, tiny)
        v_raw = vjp(u)
        alpha = torch.linalg.norm(v_raw)
        v = v_raw / torch.maximum(alpha, tiny)
        gnorm = alpha * beta1  # ||J^T r||
        eta = torch.minimum(torch.as_tensor(cg_tol, dtype=r.dtype, device=r.device), torch.sqrt(gnorm))
        tol = eta * gnorm
        x, w, phibar, rhobar, ntest, k = torch.zeros_like(g), v, beta1, alpha, gnorm + tol, 0
        while k < max_cg and bool(ntest > tol):
            u_new = jvp_lin(v) - alpha * u
            beta = torch.linalg.norm(u_new)
            u_new = u_new / torch.maximum(beta, tiny)
            v_new = vjp(u_new) - beta * v
            alpha_new = torch.linalg.norm(v_new)
            v_new = v_new / torch.maximum(alpha_new, tiny)
            # eliminate the damping row
            rhobar1 = torch.sqrt(rhobar * rhobar + damp * damp)
            phibar1 = (rhobar / torch.maximum(rhobar1, tiny)) * phibar
            # Givens rotation on the bidiagonal
            rho = torch.sqrt(rhobar1 * rhobar1 + beta * beta)
            c = rhobar1 / torch.maximum(rho, tiny)
            s = beta / torch.maximum(rho, tiny)
            theta_ = s * alpha_new
            phi = c * phibar1
            phibar_new = s * phibar1
            x = x + (phi / torch.maximum(rho, tiny)) * w
            w = v_new - (theta_ / torch.maximum(rho, tiny)) * w
            # |phibar alpha c|: phibar carries an alternating sign
            ntest = torch.abs(phibar_new * alpha_new * c)
            u, v, alpha, phibar, rhobar, k = u_new, v_new, alpha_new, phibar_new, -c * alpha_new, k + 1
        pred = r + jvp_lin(x)
        return x, torch.sum(r * r) - torch.sum(pred * pred), torch.max(torch.abs(g)), k

    return r_and_J, loss_of, {
        "normal": lm_step, "host": lm_step_host, "qr": lm_step_qr, "cg": lm_step_cg, "lsqr": lm_step_lsqr,
    }


def gauss_newton(
    problem,
    params,
    data=None,
    iterations: int = 100,
    damping_init: float = 1e-3,
    damping_max: float = 1e12,
    gtol: float = 0.0,
    ftol: float = 0.0,
    verbose: bool = True,
    log_every: int = 10,
    host_solve: Optional[bool] = None,
    jac_chunk: Optional[int] = None,
    solve: Optional[str] = None,
    mesh=None,
    cg_maxiter: Optional[int] = None,
    cg_tol: float = 1e-3,
    cg_precond: int = 0,
) -> GNResult:
    """Levenberg-Marquardt from `params` (left as they are; the result holds
    new tensors).

    `iterations` counts accepted steps; each costs one Jacobian build.  The
    damping lambda follows Nielsen's rule: an accepted step of gain ratio
    rho scales it by max(1/3, 1 - (2 rho - 1)^3), a rejection by 2, 4, 8, ...
    and reuses (r, J).  It stops on gtol (|J^T r|_inf), ftol (the relative
    loss decrease of an accepted step), a damping above damping_max, or the
    iteration budget.  `solve` picks the damped step (module docstring);
    None: "host" for parameters below float64, "normal" for float64, or
    `host_solve`'s choice when that is given.  `mesh` is not ported."""
    if solve is None:
        if host_solve is not None:
            solve = "host" if host_solve else "normal"
    elif solve not in SOLVES:
        raise ValueError(f"solve must be 'normal', 'host', 'qr', 'cg' or 'lsqr', got {solve!r}")
    if mesh is not None:
        raise NotImplementedError("gauss_newton: mesh (multi-device) is not ported yet (ROADMAP.md, queue A item 24)")
    use_ieee_fp32_matmuls()
    data = problem.data if data is None else data
    resvec = make_residual_vector(problem)
    theta, unravel = ravel_params(params)

    with torch.no_grad():
        probe = resvec(unravel(theta), data)
        loss_probe = float(problem.loss_fn(unravel(theta), data)[0])
        sq = float(torch.sum(probe * probe))
    # The LM objective must be the training loss: a loss term the residual
    # vector misses (an unregistered regularizer) fails here.
    if not np.isclose(sq, loss_probe, rtol=1e-4, atol=1e-12):
        raise ValueError(
            f"residual-vector identity violated: sum(r^2)={sq:.6e} vs loss={loss_probe:.6e}; the problem's loss "
            "contains terms outside extras['residual_fn'] + boundary data (+ extras['reg_resvec_fn'])"
        )
    n_res, n_params = int(probe.numel()), int(theta.numel())
    if solve is None:
        solve = "host" if theta.dtype != torch.float64 else "normal"
    matrix_free = solve in ("cg", "lsqr")
    if matrix_free or n_params <= n_res:
        # forward mode: one JVP first, so that a function without a JVP rule
        # (deriv_mode "pallas") raises its own error before any work
        torch.func.jvp(lambda th: resvec(unravel(th), data), (theta,), (torch.zeros_like(theta),))
    r_and_J, loss_of, lm_steps = _build_kernels(
        resvec, unravel, data, n_params, n_res, jac_chunk=jac_chunk,
        cg_maxiter=cg_maxiter, cg_tol=cg_tol, cg_precond=cg_precond,
    )
    lm_step = lm_steps[solve]

    def aux_of(th):
        with torch.no_grad():
            return _aux_floats(problem.loss_fn(unravel(th), data)[1])

    lam, nu = float(damping_init), 2.0
    records = []
    stopped = "iterations"
    accepted = 0
    t0 = time.perf_counter()

    if matrix_free:
        r = J = None
        loss = float(loss_of(theta))
    else:
        r, J = r_and_J(theta)
        loss = float(torch.sum(r * r))
    cg_iters = None
    it = 0
    while accepted < iterations:
        it += 1
        lam_t = torch.tensor(lam, dtype=theta.dtype, device=theta.device)
        if matrix_free:
            delta, pred_dec, grad_inf, cg_iters = lm_step(theta, lam_t)
        else:
            delta, pred_dec, grad_inf = lm_step(r, J, lam_t)
        if delta is None:  # the host factorization failed: reject, inflate the damping
            lam, nu = lam * nu, 2.0 * nu
            if lam > damping_max:
                stopped = "damping"
                break
            continue
        if float(grad_inf) <= gtol:
            stopped = "gtol"
            break
        theta_try = theta + delta
        loss_try = float(loss_of(theta_try))
        pred = float(pred_dec)
        rho = (loss - loss_try) / pred if pred > 0 else -1.0
        if rho > 0 and np.isfinite(loss_try):  # accept
            rel_dec = (loss - loss_try) / max(loss, 1e-300)
            theta, loss = theta_try, loss_try
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            accepted += 1
            rec = {"iteration": accepted, "damping": lam, **aux_of(theta)}
            if cg_iters is not None:
                rec["cg_iters"] = float(cg_iters)
            records.append(rec)
            if verbose and accepted % log_every == 0:
                print(f"GN it {accepted}: loss {loss:.6e}, lam {lam:.1e}, |g|_inf {float(grad_inf):.2e}")
            if ftol > 0 and rel_dec < ftol:
                stopped = "ftol"
                break
            if not matrix_free:
                r, J = r_and_J(theta)
        else:  # reject: inflate the damping, reuse (r, J)
            lam, nu = lam * nu, 2.0 * nu
            if lam > damping_max:
                stopped = "damping"
                break

    final_aux = aux_of(theta)
    keys = sorted({k for rec in records for k in rec})
    history = {k: np.asarray([rec.get(k, np.nan) for rec in records]) for k in keys}
    return GNResult(
        params=map_params(torch.clone, unravel(theta)),
        history=history,
        iterations_run=it,
        accepted=accepted,
        wall_time_s=time.perf_counter() - t0,
        stopped=stopped,
        final_aux=final_aux,
    )
