"""Classical Galerkin spectral-element direct solvers: Poisson 1D/2D/3D,
Helmholtz-2D, space-time advection-diffusion (1D and 2D), Burgers and the
steady and unsteady Navier-Stokes systems, and the optimization-gap
reports that hold a trained network against them.

Counterpart of hpvpinns_tpu/galerkin.py, with the same names and
signatures.  The arithmetic is host-side float64 numpy/scipy, as there:
the weak form the network is trained on, e.g. a(u, v) = ∫ u'v' = ∫ f v,
solved exactly (to quadrature precision) by assembling and inverting the
stiffness system on a C0 spectral-element space built from the package's
own spectral layer:

  * per element: linear hat modes N0 = (1-xi)/2, N1 = (1+xi)/2 for C0
    continuity + the same boundary-vanishing bubble modes
    phi_n = P_{n+1} - P_{n-1} the VPINN tests against (spectral/basis.py);
  * Gauss-Lobatto-Jacobi quadrature (spectral/quadrature.py) for all
    integrals.

The `vpinn_gap_*` reports evaluate the network through evaluate.predict,
on the problem's device and in its dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hpvpinns_tpu_torch.geometry.mesh import Interval1D
from hpvpinns_tpu_torch.spectral.basis import make_test_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi


@dataclass(frozen=True)
class SpectralElementSolution1D:
    """u_h in the C0 spectral-element space: nodal values at element
    boundaries + per-element bubble coefficients."""

    mesh: Interval1D
    p: int  # bubbles per element = p - 1
    nodal: np.ndarray  # [E+1]
    bubble: np.ndarray  # [E, p-1]

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        flat = x.reshape(-1)
        e = self.mesh.locate(flat)
        lo = self.mesh.grid[e]
        hi = self.mesh.grid[e + 1]
        xi = 2.0 * (flat - lo) / (hi - lo) - 1.0
        n_b = self.p - 1
        u = self.nodal[e] * (1 - xi) / 2 + self.nodal[e + 1] * (1 + xi) / 2
        if n_b > 0:
            tb = make_test_basis(n_b, xi)  # phi: [n_b, P]
            # per point: sum_n bubble[e_point, n] * phi_n(xi_point)
            u = u + np.sum(self.bubble[e] * tb.phi.T, axis=1)
        return u.reshape(x.shape)

    def derivative(self, x):
        """Exact du/dx at arbitrary points (analytic basis derivatives)."""
        x = np.asarray(x, dtype=np.float64)
        flat = x.reshape(-1)
        e = self.mesh.locate(flat)
        lo = self.mesh.grid[e]
        hi = self.mesh.grid[e + 1]
        jac = (hi - lo) / 2.0
        xi = 2.0 * (flat - lo) / (hi - lo) - 1.0
        n_b = self.p - 1
        du = (self.nodal[e + 1] - self.nodal[e]) / 2.0
        if n_b > 0:
            tb = make_test_basis(n_b, xi)
            du = du + np.sum(self.bubble[e] * tb.dphi.T, axis=1)
        return (du / jac).reshape(x.shape)


def solve_poisson1d(
    mesh: Interval1D,
    p: int,
    f_fn,
    bc: tuple,
    n_quad: int | None = None,
) -> SpectralElementSolution1D:
    """Solve -u'' = f on the mesh with Dirichlet bc = (u(a), u(b)) using
    degree-p elements (1 linear + p-1 bubble modes per element).

    Returns the discrete solution; accuracy is spectral in p for smooth f.
    """
    if p < 1:
        raise ValueError(f"polynomial degree p must be >= 1, got {p}")
    E = mesh.n_elem
    n_b = p - 1
    Q = n_quad or max(2 * p + 2, 10)
    xi, w = gauss_lobatto_jacobi(Q, 0.0, 0.0)

    # Reference-element basis values/derivatives: rows = [N0, N1, bubbles].
    tb = make_test_basis(max(n_b, 1), xi)
    B_val = np.vstack([(1 - xi) / 2, (1 + xi) / 2] + ([tb.phi[:n_b]] if n_b else []))
    B_der = np.vstack([np.full_like(xi, -0.5), np.full_like(xi, 0.5)] + ([tb.dphi[:n_b]] if n_b else []))
    nb_local = 2 + n_b

    # Element stiffness on the reference element: K_ref[i,j] = sum w B'_i B'_j
    K_ref = (B_der * w) @ B_der.T  # scaled by 1/jac per element below

    # Global DOF numbering: nodes 0..E, then bubbles element-major.
    n_nodes = E + 1
    n_dof = n_nodes + E * n_b
    K = np.zeros((n_dof, n_dof))
    F = np.zeros(n_dof)
    jac = mesh.jacobians
    x_elem = mesh.map_points(xi)  # [E, Q]
    f_vals = np.asarray(f_fn(x_elem), dtype=np.float64).reshape(E, len(xi))

    for e in range(E):
        dofs = [e, e + 1] + [n_nodes + e * n_b + i for i in range(n_b)]
        Ke = K_ref / jac[e]
        Fe = jac[e] * (B_val * w) @ f_vals[e]
        K[np.ix_(dofs, dofs)] += Ke
        F[dofs] += Fe

    # Dirichlet elimination at the two end nodes.
    ua, ub = bc
    fixed = {0: float(ua), E: float(ub)}
    free = np.asarray([i for i in range(n_dof) if i not in fixed], dtype=np.int64)
    F_free = F[free] - K[np.ix_(free, list(fixed))] @ np.asarray(list(fixed.values()))
    u_free = np.linalg.solve(K[np.ix_(free, free)], F_free)

    u = np.zeros(n_dof)
    u[free] = u_free
    for i, v in fixed.items():
        u[i] = v
    nodal = u[:n_nodes]
    bubble = u[n_nodes:].reshape(E, n_b) if n_b else np.zeros((E, 0))
    return SpectralElementSolution1D(mesh=mesh, p=p, nodal=nodal, bubble=bubble)


def _axis_h0_operators(axis: Interval1D, p: int, n_quad: int):
    """Per-axis global operators over the H0 C0 spectral-element space
    (interior nodes + all bubbles; boundary nodes excluded).

    Returns (A, M, W, B_pointeval) where
      A[i,j] = ∫ B_i' B_j' dx,  M[i,j] = ∫ B_i B_j dx,
      W[i,(e,q)] = jac_e w_q B_i(x_eq)  (quadrature-weighted evaluation), and
      B_pointeval(x) -> [n_dof, len(x)] basis values at arbitrary points.
    """
    E = axis.n_elem
    n_b = p - 1
    xi, w = gauss_lobatto_jacobi(n_quad, 0.0, 0.0)
    tb = make_test_basis(max(n_b, 1), xi)
    B_val = np.vstack([(1 - xi) / 2, (1 + xi) / 2] + ([tb.phi[:n_b]] if n_b else []))
    B_der = np.vstack(
        [np.full_like(xi, -0.5), np.full_like(xi, 0.5)] + ([tb.dphi[:n_b]] if n_b else [])
    )
    K_ref = (B_der * w) @ B_der.T
    M_ref = (B_val * w) @ B_val.T

    # Global H0 numbering: interior nodes 0..E-2, then bubbles element-major.
    n_int = E - 1
    n_dof = n_int + E * n_b
    A = np.zeros((n_dof, n_dof))
    M = np.zeros((n_dof, n_dof))
    W = np.zeros((n_dof, E * len(xi)))
    Wd = np.zeros((n_dof, E * len(xi)))  # w_q B'_i,xi (reference derivative;
    # the 1/jac of d/dx cancels the jac of dx in axis-derivative integrals)
    jac = axis.jacobians

    def dofs_of(e):
        # local rows: [N0 (left node), N1 (right node), bubbles]; boundary
        # nodes (global 0 and E) are not DOFs -> -1.
        left = e - 1 if e > 0 else -1
        right = e if e < E - 1 else -1
        return [left, right] + [n_int + e * n_b + i for i in range(n_b)]

    for e in range(E):
        dofs = dofs_of(e)
        keep = [k for k, d in enumerate(dofs) if d >= 0]
        gd = [dofs[k] for k in keep]
        A[np.ix_(gd, gd)] += K_ref[np.ix_(keep, keep)] / jac[e]
        M[np.ix_(gd, gd)] += jac[e] * M_ref[np.ix_(keep, keep)]
        cols = slice(e * len(xi), (e + 1) * len(xi))
        W[gd, cols] = jac[e] * (B_val[keep] * w)
        Wd[gd, cols] = B_der[keep] * w

    def point_eval(x):
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        e = axis.locate(x)
        lo, hi = axis.grid[e], axis.grid[e + 1]
        xi_p = 2.0 * (x - lo) / (hi - lo) - 1.0
        out = np.zeros((n_dof, len(x)))
        hat_l, hat_r = (1 - xi_p) / 2, (1 + xi_p) / 2
        for j in range(len(x)):
            dofs = dofs_of(e[j])
            if dofs[0] >= 0:
                out[dofs[0], j] += hat_l[j]
            if dofs[1] >= 0:
                out[dofs[1], j] += hat_r[j]
        if n_b:
            tbp = make_test_basis(n_b, xi_p)  # [n_b, P]
            for i in range(n_b):
                out[n_int + e * n_b + i, np.arange(len(x))] += tbp.phi[i]
        return out

    return A, M, W, Wd, point_eval


@dataclass(frozen=True)
class SpectralElementSolution2D:
    """u_h = lift + tensor-product H0 spectral-element correction."""

    coef: np.ndarray  # [n_dof_x, n_dof_y]
    eval_x: object
    eval_y: object
    lift: object  # lift(x, y) -> array, or None

    def __call__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        Bx = self.eval_x(x.reshape(-1))  # [nx, P]
        By = self.eval_y(y.reshape(-1))  # [ny, P]
        w = np.einsum("ip,ij,jp->p", Bx, self.coef, By)
        u = w.reshape(x.shape)
        if self.lift is not None:
            u = u + self.lift(x, y)
        return u


def coons_lift(g_fn, domain_x, domain_y):
    """Transfinite (Coons) boundary interpolant: uses g ONLY on the four
    edges of the rectangle, matches it there exactly."""
    a, b = domain_x
    c, d = domain_y

    def lift(x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        s = (x - a) / (b - a)
        t = (y - c) / (d - c)
        return (
            (1 - s) * g_fn(np.full_like(x, a), y)
            + s * g_fn(np.full_like(x, b), y)
            + (1 - t) * g_fn(x, np.full_like(y, c))
            + t * g_fn(x, np.full_like(y, d))
            - (1 - s) * (1 - t) * g_fn(np.full_like(x, a), np.full_like(y, c))
            - s * (1 - t) * g_fn(np.full_like(x, b), np.full_like(y, c))
            - (1 - s) * t * g_fn(np.full_like(x, a), np.full_like(y, d))
            - s * t * g_fn(np.full_like(x, b), np.full_like(y, d))
        )

    return lift


def solve_poisson2d(
    mesh,
    p: int,
    f_fn,
    lift_fn=None,
    lift_grad_fn=None,
    n_quad: int | None = None,
) -> SpectralElementSolution2D:
    """Direct tensor-product spectral-element solve of Delta u = f (the
    reference's f = Delta u convention, Poisson-2D.py:307-310) with Dirichlet
    data supplied as a boundary lift: u = lift + w, w in H0, solving

        a(w, v) = -∫∫ f v - a(lift, v),
        a(u, v) = ∫∫ grad u . grad v = (A_x ⊗ M_y + M_x ⊗ A_y) form.

    The lift term is integrated by parts-free (a(lift, v) by quadrature of
    grad lift . grad v), so only FIRST derivatives of the lift are needed —
    lift_grad_fn(x, y) -> (lift_x, lift_y), or central differences when None.
    Spectral accuracy in p for smooth data; lift_fn=None means homogeneous
    Dirichlet."""
    ax, ay = mesh.axis_x, mesh.axis_y
    Q = n_quad or max(2 * p + 2, 10)
    Ax, Mx, Wx, Wdx, ex = _axis_h0_operators(ax, p, Q)
    Ay, My, Wy, Wdy, ey = _axis_h0_operators(ay, p, Q)

    xi, _ = gauss_lobatto_jacobi(Q, 0.0, 0.0)
    Xg = ax.map_points(xi).reshape(-1)  # [Ex*Q]
    Yg = ay.map_points(xi).reshape(-1)  # [Ey*Q]
    XX, YY = np.meshgrid(Xg, Yg, indexing="ij")
    rhs = -np.asarray(f_fn(XX, YY), dtype=np.float64)
    F = Wx @ rhs @ Wy.T  # [nx, ny]

    lift = None
    if lift_fn is not None:
        lift = lambda x, y: np.asarray(lift_fn(x, y), dtype=np.float64)
        if lift_grad_fn is None:
            h = 1e-6

            def lift_grad_fn(x, y):
                return (
                    (lift(x + h, y) - lift(x - h, y)) / (2 * h),
                    (lift(x, y + h) - lift(x, y - h)) / (2 * h),
                )

        gx, gy = lift_grad_fn(XX, YY)
        # a(lift, v) = ∫∫ lift_x v_x + lift_y v_y:
        #   x-part: (w B'_xi)_x ⊗ (jac w B)_y — the 1/jac of d/dx cancels
        #   the jac of dx (Wd carries no jac); symmetric for y.
        F = F - (Wdx @ np.asarray(gx, dtype=np.float64) @ Wy.T)
        F = F - (Wx @ np.asarray(gy, dtype=np.float64) @ Wdy.T)

    K = np.kron(Ax, My) + np.kron(Mx, Ay)
    coef = np.linalg.solve(K, F.reshape(-1)).reshape(F.shape)
    return SpectralElementSolution2D(coef=coef, eval_x=ex, eval_y=ey, lift=lift)


def solve_helmholtz2d(
    mesh,
    p: int,
    k_sq: float,
    f_fn,
    lift_fn=None,
    lift_grad_fn=None,
    n_quad: int | None = None,
) -> SpectralElementSolution2D:
    """Direct tensor-product spectral-element solve of the INDEFINITE
    Helmholtz problem  Delta u + k^2 u = f  (no reference analog; the
    oscillatory extension of solve_poisson2d).  With u = lift + w, w in H0:

        a(w, v) - k^2 m(w, v) = -∫∫ f v - a(lift, v) + k^2 m(lift, v),
        a = (A_x ⊗ M_y + M_x ⊗ A_y),  m = M_x ⊗ M_y.

    The system is symmetric indefinite for k^2 above the first Dirichlet
    eigenvalue — np.linalg.solve (LU) handles it; accuracy degrades only
    when k^2 approaches a DISCRETE eigenvalue of the pencil (A, m), which
    converges to a continuous one at spectral rate, so keep the continuous
    problem comfortably off-resonance (Helmholtz2DConfig's default does)."""
    ax, ay = mesh.axis_x, mesh.axis_y
    Q = n_quad or max(2 * p + 2, 10)
    Ax, Mx, Wx, Wdx, ex = _axis_h0_operators(ax, p, Q)
    Ay, My, Wy, Wdy, ey = _axis_h0_operators(ay, p, Q)

    xi, _ = gauss_lobatto_jacobi(Q, 0.0, 0.0)
    Xg = ax.map_points(xi).reshape(-1)
    Yg = ay.map_points(xi).reshape(-1)
    XX, YY = np.meshgrid(Xg, Yg, indexing="ij")
    F = Wx @ (-np.asarray(f_fn(XX, YY), dtype=np.float64)) @ Wy.T

    lift = None
    if lift_fn is not None:
        lift = lambda x, y: np.asarray(lift_fn(x, y), dtype=np.float64)
        if lift_grad_fn is None:
            h = 1e-6

            def lift_grad_fn(x, y):
                return (
                    (lift(x + h, y) - lift(x - h, y)) / (2 * h),
                    (lift(x, y + h) - lift(x, y - h)) / (2 * h),
                )

        gx, gy = lift_grad_fn(XX, YY)
        F = F - (Wdx @ np.asarray(gx, dtype=np.float64) @ Wy.T)
        F = F - (Wx @ np.asarray(gy, dtype=np.float64) @ Wdy.T)
        F = F + k_sq * (Wx @ lift(XX, YY) @ Wy.T)

    K = np.kron(Ax, My) + np.kron(Mx, Ay) - k_sq * np.kron(Mx, My)
    coef = np.linalg.solve(K, F.reshape(-1)).reshape(F.shape)
    return SpectralElementSolution2D(coef=coef, eval_x=ex, eval_y=ey, lift=lift)


def vpinn_gap_helmholtz2d(problem, params, p: int = 24, n_points: int = 101) -> dict:
    """Helmholtz optimization-gap report (network vs exact vs direct solve)
    — the oscillatory twin of vpinn_gap_2d.  Dirichlet data enters through
    the Coons boundary interpolant of the exact solution; p defaults higher
    than the Poisson gap's because the direct solve must resolve ~k/pi
    waves per axis."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    mesh = problem.extras["mesh"]
    f_fn = problem.extras["f_rhs"]
    k_sq = problem.extras["k_sq_true"]
    u_ex_fn = problem.exact
    cfg = problem.config
    u_dir = solve_helmholtz2d(
        mesh, p, k_sq, f_fn,
        lift_fn=coons_lift(u_ex_fn, cfg.domain_x, cfg.domain_y),
    )

    xs = np.linspace(*cfg.domain_x, n_points)
    ys = np.linspace(*cfg.domain_y, n_points)
    XG, YG = np.meshgrid(xs, ys)
    pts = np.stack([XG.reshape(-1), YG.reshape(-1)], axis=-1)
    u_net = predict(problem, params, pts).reshape(-1)
    u_g = u_dir(XG, YG).reshape(-1)
    u_true = np.asarray(u_ex_fn(XG, YG)).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_true),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_true),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


def vpinn_gap_2d(problem, params, p: int = 12, n_points: int = 101) -> dict:
    """2D optimization-gap report: network vs exact, direct solve vs exact,
    network vs direct solve — on the problem's own mesh and forcing.

    The Dirichlet data enters through a Coons boundary interpolant of the
    exact solution (boundary values only — the interior comes entirely from
    the solve)."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    mesh = problem.extras["mesh"]
    f_fn = problem.extras["f_rhs"]
    u_ex_fn = problem.exact
    cfg0 = problem.config
    u_dir = solve_poisson2d(
        mesh, p, f_fn, lift_fn=coons_lift(u_ex_fn, cfg0.domain_x, cfg0.domain_y)
    )

    cfg = problem.config
    xs = np.linspace(*cfg.domain_x, n_points)
    ys = np.linspace(*cfg.domain_y, n_points)
    XG, YG = np.meshgrid(xs, ys)
    pts = np.stack([XG.reshape(-1), YG.reshape(-1)], axis=-1)
    u_net = predict(problem, params, pts).reshape(-1)
    u_g = u_dir(XG, YG).reshape(-1)
    u_true = np.asarray(u_ex_fn(XG, YG)).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_true),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_true),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


def vpinn_gap_1d(problem, params, p: int = 40, n_points: int = 2001) -> dict:
    """Quantify the VPINN's distance from (a) the exact solution and (b) the
    direct spectral-element solution of the same weak form on the same mesh.

    Returns rel-L2 of the network vs exact, of the direct solve vs exact,
    and of the network vs the direct solve (the pure optimization gap)."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    mesh = problem.extras["mesh"]
    if not isinstance(mesh, Interval1D):
        raise TypeError("vpinn_gap_1d supports 1D problems")
    f_fn = problem.extras.get("f_rhs")
    if f_fn is None:
        raise ValueError("problem.extras['f_rhs'] missing — vpinn_gap_1d needs the problem's forcing")

    cfg = problem.config
    u_dir = solve_poisson1d(
        mesh, p, f_fn, (float(problem.exact(np.array(cfg.domain[0]))), float(problem.exact(np.array(cfg.domain[1]))))
    )
    x = np.linspace(cfg.domain[0], cfg.domain[1], n_points)[:, None]
    u_net = predict(problem, params, x).reshape(-1)
    u_g = u_dir(x).reshape(-1)
    u_ex = np.asarray(problem.exact(x)).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_ex),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_ex),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


# ---------------------------------------------------------------------------
# Space-time advection-diffusion: spectral-element in x, EXACT propagation
# in t (method of lines; the semi-discrete system is linear ODEs solved by
# eigendecomposition + a Duhamel integral for forcing).  The deterministic
# companion of the advdiff VPINN family (problems/advdiff.py; reference weak
# form AdvDiff.py:161-180) — supports VARIABLE eps(x) and V(x), which the
# reference's closed-form Fourier solution (AdvDiff.py:416-445) cannot.
# ---------------------------------------------------------------------------


def _axis_h0_quadrature(axis: Interval1D, p: int, n_quad: int):
    """Raw global H0 basis data at quadrature points: values B[i, EQ],
    physical derivatives Bx[i, EQ], combined weights wq[EQ] (= jac_e w_q),
    points x[EQ], and an arbitrary-point evaluator."""
    A, M, W, Wd, point_eval = _axis_h0_operators(axis, p, n_quad)
    E = axis.n_elem
    xi, w = gauss_lobatto_jacobi(n_quad, 0.0, 0.0)
    x_g = axis.map_points(xi).reshape(-1)  # [E*Q]
    B = point_eval(x_g)  # [n_dof, EQ] (values; exact at quad points)
    jac = np.repeat(axis.jacobians, len(xi))
    wq = jac * np.tile(w, E)
    # physical derivative via the weighted reference-derivative array:
    # Wd[i,(e,q)] = w_q B'_i,ref  ->  B'_i,phys = Wd / (w_q jac_e)
    Bx = Wd / (np.tile(w, E)[None, :] * jac[None, :])
    return B, Bx, wq, x_g, point_eval, M


def _detect_exp_decay(f_fn, probe_args, t_probe=(0.31, 0.77)):
    """If f(..., t) = e^{-r t} g(...) for a constant rate r, return r; else
    None.  Probed numerically on a fixed argument grid — exactness to 1e-11
    relative is required, so genuinely non-separable forcings fall back to
    quadrature Duhamel."""
    f0 = np.asarray(f_fn(*probe_args, np.zeros_like(probe_args[0])), dtype=np.float64)
    if not np.all(np.isfinite(f0)) or np.max(np.abs(f0)) == 0:
        return None
    m = np.abs(f0) > 1e-8 * np.max(np.abs(f0))
    if not m.any():
        return None
    rates = []
    for tp in t_probe:
        ft = np.asarray(f_fn(*probe_args, np.full_like(probe_args[0], tp)), dtype=np.float64)
        ratio = ft[m] / f0[m]
        if np.any(ratio <= 0):
            return None
        r = -np.log(ratio) / tp
        if np.max(np.abs(r - r.flat[0])) > 1e-9 * max(1.0, abs(r.flat[0])):
            return None
        rates.append(float(r.flat[0]))
    if abs(rates[0] - rates[1]) > 1e-9 * max(1.0, abs(rates[0])):
        return None
    return rates[0]


@dataclass(frozen=True)
class SpectralElementSolutionAdvDiff:
    """u_h(x, t) over the H0(x) spectral-element space: eigen-propagated
    coefficients (exact in t for the semi-discrete system)."""

    axis: Interval1D
    p: int
    _propagate: object  # t -> coefficient vector [n_dof]
    _point_eval: object

    def __call__(self, x, t):
        x = np.asarray(x, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        x, t = np.broadcast_arrays(x, t)
        flat_x, flat_t = x.reshape(-1), t.reshape(-1)
        out = np.empty(flat_x.shape)
        # one propagation per unique time (the eigenbasis makes each O(n^2))
        for tv in np.unique(flat_t):
            sel = flat_t == tv
            B = self._point_eval(flat_x[sel])  # [n_dof, P]
            out[sel] = self._propagate(float(tv)) @ B
        return out.reshape(x.shape)


def solve_advdiff(
    axis: Interval1D,
    p: int,
    u0_fn,
    epsilon,
    velocity,
    f_fn=None,
    n_quad: int | None = None,
    n_quad_t: int = 48,
) -> SpectralElementSolutionAdvDiff:
    """Direct solve of  u_t + V(x) u_x - eps(x) u_xx = f(x, t)  on
    axis x [0, inf), homogeneous Dirichlet walls (the benchmark BC,
    AdvDiff.py:351-353; manufactured profiles also vanish at the walls).

    Semi-discrete Galerkin over the H0 C0 spectral-element space:

        M c' + [C_V + C_eps' + K_eps] c = F(t)

    (the non-divergence diffusion integrates by parts into BOTH terms, the
    same identity the VPINN's var_form 1 uses — ops/assembly.py).  The ODE
    system is solved EXACTLY by eigendecomposition; forcing enters through
    a Duhamel integral evaluated by Gauss-Legendre in time (`n_quad_t`
    points per query time).  `epsilon`/`velocity` may be floats or
    callables eps(x), V(x); callable epsilon uses torch.func.jvp for d(eps)/dx (exact)
    with a finite-difference fallback.  Accuracy is spectral in p.
    """
    if p < 1:
        raise ValueError(f"polynomial degree p must be >= 1, got {p}")
    Q = n_quad or max(2 * p + 2, 10)
    B, Bx, wq, x_g, point_eval, M = _axis_h0_quadrature(axis, p, Q)

    eps_g = np.asarray(epsilon(x_g) if callable(epsilon) else epsilon, dtype=np.float64)
    eps_g = np.broadcast_to(eps_g, x_g.shape)
    if callable(epsilon):
        try:
            import torch

            xt = torch.as_tensor(x_g, dtype=torch.float64)
            _, deps = torch.func.jvp(epsilon, (xt,), (torch.ones_like(xt),))
            epsx_g = np.asarray(deps, dtype=np.float64)
        except Exception:
            h = 1e-7
            epsx_g = (np.asarray(epsilon(x_g + h)) - np.asarray(epsilon(x_g - h))) / (2 * h)
    else:
        epsx_g = np.zeros_like(x_g)
    v_g = np.asarray(velocity(x_g) if callable(velocity) else velocity, dtype=np.float64)
    v_g = np.broadcast_to(v_g, x_g.shape)

    # Operator rows = test i, cols = trial j.
    Op = (
        (B * (wq * v_g)) @ Bx.T  # ∫ V B_j' B_i
        + (B * (wq * epsx_g)) @ Bx.T  # ∫ eps_x B_j' B_i
        + (Bx * (wq * eps_g)) @ Bx.T  # ∫ eps B_j' B_i'
    )

    # L2 projection of the initial condition.
    u0_g = np.asarray(u0_fn(x_g), dtype=np.float64).reshape(-1)
    c0 = np.linalg.solve(M, (B * wq) @ u0_g)

    # Propagation of  c' = A c + M^{-1} F,  A = -M^{-1} Op, by
    # scaling-and-squaring expm (scipy, already a lazy dependency of the
    # records tier).  NOT by eigendecomposition: the advection-dominated
    # operator is strongly non-normal (measured cond(eigvecs) ~ 1e13 at the
    # benchmark Peclet), which caps eigen-propagation at ~3e-5 accuracy
    # while expm reaches the discretization floor (~1e-8 at p = 40).
    A_sys = -np.linalg.solve(M, Op)
    from scipy.linalg import expm

    zt, zw = np.polynomial.legendre.leggauss(n_quad_t)  # on [-1, 1]

    def propagate(t: float) -> np.ndarray:
        c = expm(A_sys * t) @ c0
        if f_fn is not None and t > 0:
            # Duhamel: c += int_0^t expm(A (t-s)) M^{-1} F(s) ds by
            # Gauss-Legendre in s;  F_i(s) = ∫ f(x, s) B_i dx.
            s = 0.5 * t * (zt + 1.0)
            ws = 0.5 * t * zw
            F = (B * wq) @ np.asarray(
                f_fn(x_g[:, None], np.broadcast_to(s, (len(x_g), len(s)))),
                dtype=np.float64,
            )  # [n_dof, n_t]
            G = np.linalg.solve(M, F)
            for k in range(len(s)):
                c = c + ws[k] * (expm(A_sys * (t - s[k])) @ G[:, k])
        return c

    return SpectralElementSolutionAdvDiff(
        axis=axis, p=p, _propagate=propagate, _point_eval=point_eval
    )


def vpinn_gap_advdiff(problem, params, p: int = 40, n_points: int = 101) -> dict:
    """Optimization-gap report for the space-time advdiff family: network vs
    exact, direct solve vs exact, network vs direct solve — using the
    problem's OWN truth (eps_true or the manufactured epsilon_fn/velocity_fn
    and forcing).  The direct solve also independently validates the 800-term
    Fourier benchmark series (AdvDiff.py:416-445)."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    if problem.name != "advdiff":
        raise ValueError(f"vpinn_gap_advdiff supports advdiff problems, got {problem.name!r}")
    cfg = problem.config
    mesh = problem.extras["mesh"]
    eps = problem.extras.get("epsilon_fn") or problem.extras["eps_true"]
    vfn = problem.extras.get("velocity_fn")
    vel = vfn if vfn is not None else cfg.velocity
    f_fn = problem.extras.get("f_rhs")  # None for the homogeneous benchmark
    exact = problem.exact
    u0 = lambda x: np.asarray(exact(x.reshape(-1, 1), np.zeros((x.size, 1)))).reshape(x.shape)  # noqa: E731

    u_dir = solve_advdiff(mesh.axis_x, p, u0, eps, vel, f_fn=f_fn)

    xs = np.linspace(*cfg.domain_x, n_points)
    ts = np.linspace(0.0, cfg.t_final, n_points)
    XG, TG = np.meshgrid(xs, ts)
    pts = np.stack([XG.reshape(-1), TG.reshape(-1)], axis=-1)
    u_net = predict(problem, params, pts).reshape(-1)
    u_g = u_dir(XG, TG).reshape(-1)
    u_true = np.asarray(exact(pts[:, 0:1], pts[:, 1:2])).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_true),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_true),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


@dataclass(frozen=True)
class SpectralElementSolutionAdvDiff2D:
    """u_h(x, y, t): tensor H0(x) x H0(y) coefficients, expm-propagated."""

    _propagate: object  # t -> coefficient vector [nx*ny]
    _point_eval_x: object
    _point_eval_y: object

    def __call__(self, x, y, t):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        x, y, t = np.broadcast_arrays(x, y, t)
        fx, fy, ft = x.reshape(-1), y.reshape(-1), t.reshape(-1)
        out = np.empty(fx.shape)
        for tv in np.unique(ft):
            sel = ft == tv
            Bx = self._point_eval_x(fx[sel])  # [nx, P]
            By = self._point_eval_y(fy[sel])  # [ny, P]
            c = self._propagate(float(tv))
            nx = Bx.shape[0]
            out[sel] = np.einsum("ij,ip,jp->p", c.reshape(nx, -1), Bx, By)
        return out.reshape(x.shape)


def solve_advdiff2d(
    axis_x: Interval1D,
    axis_y: Interval1D,
    p: int,
    u0_fn,
    epsilon: float,
    vx: float,
    vy: float,
    f_fn=None,
    n_quad: int | None = None,
    n_quad_t: int = 48,
) -> SpectralElementSolutionAdvDiff2D:
    """Direct solve of  u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f  on
    axis_x x axis_y x [0, inf), homogeneous Dirichlet side walls — the 2D
    space-time companion of problems/advdiff2d.py (constant coefficients,
    matching that family's scalar (eps, vx, vy)).

    Tensor-product H0 Galerkin semi-discretization; the same expm
    propagation + Duhamel forcing as solve_advdiff.  Spectral in p.
    """
    if p < 1:
        raise ValueError(f"polynomial degree p must be >= 1, got {p}")
    Q = n_quad or max(2 * p + 2, 10)
    Bx, Bxd, wqx, xg, pex, Mx_ = _axis_h0_quadrature(axis_x, p, Q)
    By, Byd, wqy, yg, pey, My_ = _axis_h0_quadrature(axis_y, p, Q)

    Mx = (Bx * wqx) @ Bx.T
    My = (By * wqy) @ By.T
    Kx = (Bxd * wqx) @ Bxd.T
    Ky = (Byd * wqy) @ Byd.T
    Cx = (Bx * wqx) @ Bxd.T  # ∫ B_i B_j' dx  (row test, col trial)
    Cy = (By * wqy) @ Byd.T

    M = np.kron(Mx, My)
    Op = (
        vx * np.kron(Cx, My)
        + vy * np.kron(Mx, Cy)
        + epsilon * (np.kron(Kx, My) + np.kron(Mx, Ky))
    )

    XG, YG = np.meshgrid(xg, yg, indexing="ij")  # [Qx*, Qy*]
    u0_g = np.asarray(u0_fn(XG, YG), dtype=np.float64)
    F0 = np.einsum("ip,jq,pq->ij", Bx * wqx, By * wqy, u0_g).reshape(-1)
    c0 = np.linalg.solve(M, F0)

    A_sys = -np.linalg.solve(M, Op)
    from scipy.linalg import expm

    zt, zw = np.polynomial.legendre.leggauss(n_quad_t)

    # Closed-form Duhamel for separable f = e^{-r t} g(x, y) — see
    # solve_advdiff; detection + fallback identical.
    _sep = None
    if f_fn is not None:
        rate = _detect_exp_decay(f_fn, (XG, YG))
        if rate is not None:
            g0 = np.asarray(f_fn(XG, YG, np.zeros_like(XG)), dtype=np.float64)
            Fg = np.einsum("ip,jq,pq->ij", Bx * wqx, By * wqy, g0).reshape(-1)
            b_sep = np.linalg.solve(M, Fg)
            lu = A_sys + rate * np.eye(A_sys.shape[0])
            _sep = (rate, np.linalg.solve(lu, np.eye(lu.shape[0])), b_sep)

    def propagate(t: float) -> np.ndarray:
        E_t = expm(A_sys * t)
        c = E_t @ c0
        if f_fn is not None and t > 0:
            if _sep is not None:
                rate, inv_ArI, b_sep = _sep
                c = c + inv_ArI @ (E_t @ b_sep - np.exp(-rate * t) * b_sep)
            else:
                s = 0.5 * t * (zt + 1.0)
                ws = 0.5 * t * zw
                for k in range(len(s)):
                    f_g = np.asarray(
                        f_fn(XG, YG, np.full_like(XG, s[k])), dtype=np.float64
                    )
                    Fk = np.einsum("ip,jq,pq->ij", Bx * wqx, By * wqy, f_g).reshape(-1)
                    c = c + ws[k] * (expm(A_sys * (t - s[k])) @ np.linalg.solve(M, Fk))
        return c

    return SpectralElementSolutionAdvDiff2D(
        _propagate=propagate, _point_eval_x=pex, _point_eval_y=pey
    )


def vpinn_gap_advdiff2d(problem, params, p: int = 16, n_points: int = 21) -> dict:
    """Optimization-gap report for the 2D space-time family (manufactured
    truth, problems/advdiff2d.py): net vs exact, direct solve vs exact, net
    vs direct solve."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    if problem.name != "advdiff2d":
        raise ValueError(
            f"vpinn_gap_advdiff2d supports advdiff2d problems, got {problem.name!r}"
        )
    cfg = problem.config
    mesh = problem.extras["mesh"]
    vx, vy = cfg.velocity
    eps = problem.extras["eps_true"]
    f_fn = problem.extras["f_rhs"]
    exact = problem.exact
    u0 = lambda X, Y: np.asarray(exact(X, Y, np.zeros_like(X)))  # noqa: E731

    u_dir = solve_advdiff2d(mesh.axis_x, mesh.axis_y, p, u0, eps, vx, vy, f_fn=f_fn)

    xs = np.linspace(*cfg.domain_x, n_points)
    ys = np.linspace(*cfg.domain_y, n_points)
    ts = np.linspace(0.0, cfg.t_final, 6)
    XG, YG, TG = np.meshgrid(xs, ys, ts, indexing="ij")
    pts = np.stack([XG.reshape(-1), YG.reshape(-1), TG.reshape(-1)], axis=-1)
    u_net = predict(problem, params, pts).reshape(-1)
    u_g = u_dir(XG, YG, TG).reshape(-1)
    u_true = np.asarray(exact(pts[:, 0:1], pts[:, 1:2], pts[:, 2:3])).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_true),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_true),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


@dataclass(frozen=True)
class SpectralElementSolutionBurgers:
    """u_h(x, t): H0 spectral-element coefficients on a stored BDF2 time
    grid; queries interpolate coefficients linearly in t (O(dt^2), matched
    to the integrator order)."""

    t_grid: np.ndarray  # [n_steps+1]
    coefs: np.ndarray  # [n_steps+1, n_dof]
    _point_eval: object

    def __call__(self, x, t):
        x = np.asarray(x, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        x, t = np.broadcast_arrays(x, t)
        fx, ft = x.reshape(-1), t.reshape(-1)
        B = self._point_eval(fx)  # [n_dof, P]
        # linear interpolation of coefficients in time
        k = np.clip(np.searchsorted(self.t_grid, ft, side="right") - 1, 0,
                    len(self.t_grid) - 2)
        w = (ft - self.t_grid[k]) / (self.t_grid[k + 1] - self.t_grid[k])
        C = (1 - w)[:, None] * self.coefs[k] + w[:, None] * self.coefs[k + 1]
        return np.einsum("pn,np->p", C, B).reshape(x.shape)


def solve_burgers(
    axis: Interval1D,
    p: int,
    u0_fn,
    nu: float,
    t_final: float = 1.0,
    n_steps: int = 800,
    n_quad: int | None = None,
    newton_tol: float = 1e-13,
) -> SpectralElementSolutionBurgers:
    """Direct solve of  u_t + u u_x = nu u_xx  with homogeneous Dirichlet
    walls: H0 spectral elements in x (conservation-form convection,
    ∫ (u²/2)_x v = −∫ u²/2 v′ — the same IBP the VPINN's weak form uses,
    ops/assembly.py::burgers_residual), BDF2 + Newton in t.

    The nonlinear companion of solve_advdiff.  Measured vs the Cole–Hopf
    exact solution (nu = 0.01/π, front-clustered 7-element grid, p = 20,
    800 steps): rel-L2 1.7e-6 at t = 1 — the time error is the BDF2
    O(dt²) floor; the burgers VPINN quality preset sits at 8.6e-3 (the JAX
    package's f32 row).
    """
    if p < 1:
        raise ValueError(f"polynomial degree p must be >= 1, got {p}")
    Q = n_quad or max(2 * p + 2, 10)
    B, Bx, wq, x_g, point_eval, M = _axis_h0_quadrature(axis, p, Q)
    K = (Bx * wq) @ Bx.T

    u0_g = np.asarray(u0_fn(x_g), dtype=np.float64).reshape(-1)
    c = np.linalg.solve(M, (B * wq) @ u0_g)

    def rhs(c):
        u = B.T @ c
        return (Bx * wq) @ (0.5 * u * u) - nu * (K @ c)

    def jac_rhs(c):
        u = B.T @ c
        return (Bx * (wq * u)) @ B.T - nu * K

    dt = t_final / n_steps
    coefs = np.empty((n_steps + 1, len(c)))
    coefs[0] = c
    c_prev = None
    for k in range(n_steps):
        if c_prev is None:
            a0, hist = 1.0, c  # BDF1 bootstrap
        else:
            a0, hist = 1.5, 2.0 * c - 0.5 * c_prev
        c_new = c.copy()
        for _ in range(30):
            F = M @ (a0 * c_new - hist) - dt * rhs(c_new)
            Jm = a0 * M - dt * jac_rhs(c_new)
            dc = np.linalg.solve(Jm, F)
            c_new = c_new - dc
            if np.linalg.norm(dc) < newton_tol * max(1.0, np.linalg.norm(c_new)):
                break
        c_prev, c = c, c_new
        coefs[k + 1] = c

    return SpectralElementSolutionBurgers(
        t_grid=np.linspace(0.0, t_final, n_steps + 1),
        coefs=coefs,
        _point_eval=point_eval,
    )


# the measured front-resolving grid for the nu = 0.01/pi benchmark
BURGERS_SOLVER_GRID = (-1.0, -0.3, -0.05, -0.01, 0.01, 0.05, 0.3, 1.0)


def vpinn_gap_burgers(problem, params, p: int = 20, n_steps: int = 800) -> dict:
    """Optimization-gap report for the nonlinear family: net vs Cole-Hopf
    exact, direct solve vs exact, net vs direct solve."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    if problem.name != "burgers":
        raise ValueError(f"vpinn_gap_burgers supports burgers problems, got {problem.name!r}")
    cfg = problem.config
    axis = Interval1D(np.asarray(BURGERS_SOLVER_GRID))
    u_dir = solve_burgers(
        axis, p, lambda x: -np.sin(np.pi * x), cfg.nu, cfg.t_final, n_steps
    )
    pts = problem.test_points
    u_net = predict(problem, params).reshape(-1)
    u_g = u_dir(pts[:, 0], pts[:, 1]).reshape(-1)
    u_true = np.asarray(problem.test_values).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_true),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_true),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


@dataclass(frozen=True)
class SpectralElementSolution3D:
    """u_h = lift + tensor-product H0 correction (x-major coef block)."""

    coef: np.ndarray  # [nx, ny, nz]
    eval_x: object
    eval_y: object
    eval_z: object
    lift: object  # lift(x, y, z) -> array, or None

    def __call__(self, x, y, z):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        Bx = self.eval_x(x.reshape(-1))
        By = self.eval_y(y.reshape(-1))
        Bz = self.eval_z(z.reshape(-1))
        w = np.einsum("ijk,ip,jp,kp->p", self.coef, Bx, By, Bz, optimize=True)
        u = w.reshape(x.shape)
        if self.lift is not None:
            u = u + self.lift(x, y, z)
        return u


def solve_poisson3d(
    mesh,
    p: int,
    f_fn,
    lift_fn=None,
    lift_grad_fn=None,
    n_quad: int | None = None,
) -> SpectralElementSolution3D:
    """Direct tensor-product spectral-element solve of Delta u = f on a 3D
    box (TensorMesh3D) by FAST DIAGONALIZATION: per-axis generalized
    eigenproblems A v = lambda M v reduce the volumetric stiffness system
    (A⊗M⊗M + M⊗A⊗M + M⊗M⊗A) to an elementwise divide — O(n^4) instead of a
    dense O(n^9) solve, the classical fast Poisson solver on spectral
    elements.  Dirichlet data enters through `lift_fn` (u = lift + w,
    w in H0^3); `lift_grad_fn(x,y,z) -> (Lx, Ly, Lz)` or central
    differences when None.  Spectral accuracy in p for smooth data."""
    from scipy.linalg import eigh

    ax, ay, az = mesh.axis_x, mesh.axis_y, mesh.axis_z
    Q = n_quad or max(2 * p + 2, 10)
    Axo, Mx, Wx, Wdx, ex = _axis_h0_operators(ax, p, Q)
    Ayo, My, Wy, Wdy, ey = _axis_h0_operators(ay, p, Q)
    Azo, Mz, Wz, Wdz, ez = _axis_h0_operators(az, p, Q)

    xi, _ = gauss_lobatto_jacobi(Q, 0.0, 0.0)
    Xg = ax.map_points(xi).reshape(-1)
    Yg = ay.map_points(xi).reshape(-1)
    Zg = az.map_points(xi).reshape(-1)
    XX, YY, ZZ = np.meshgrid(Xg, Yg, Zg, indexing="ij")
    # a(u, v) = -(f, v) for Delta u = f (H0 test functions)
    F = np.einsum(
        "ip,jq,kr,pqr->ijk", Wx, Wy, Wz,
        -np.asarray(f_fn(XX, YY, ZZ), dtype=np.float64), optimize=True,
    )

    lift = None
    if lift_fn is not None:
        lift = lambda x, y, z: np.asarray(lift_fn(x, y, z), dtype=np.float64)  # noqa: E731
        if lift_grad_fn is None:
            h = 1e-6

            def lift_grad_fn(x, y, z):
                return (
                    (lift(x + h, y, z) - lift(x - h, y, z)) / (2 * h),
                    (lift(x, y + h, z) - lift(x, y - h, z)) / (2 * h),
                    (lift(x, y, z + h) - lift(x, y, z - h)) / (2 * h),
                )

        Lx, Ly, Lz = (np.asarray(g, dtype=np.float64) for g in lift_grad_fn(XX, YY, ZZ))
        # subtract a(lift, v): the axis-derivative contraction uses Wd (the
        # 1/jac of d/dx cancels the jac of that axis' dx — see
        # _axis_h0_operators), full weights on the other axes
        F -= np.einsum("ip,jq,kr,pqr->ijk", Wdx, Wy, Wz, Lx, optimize=True)
        F -= np.einsum("ip,jq,kr,pqr->ijk", Wx, Wdy, Wz, Ly, optimize=True)
        F -= np.einsum("ip,jq,kr,pqr->ijk", Wx, Wy, Wdz, Lz, optimize=True)

    # Fast diagonalization: A V = M V diag(lam), V^T M V = I per axis.
    lx, Vx = eigh(Axo, Mx)
    ly, Vy = eigh(Ayo, My)
    lz, Vz = eigh(Azo, Mz)
    Ft = np.einsum("ia,jb,kc,ijk->abc", Vx, Vy, Vz, F, optimize=True)
    denom = lx[:, None, None] + ly[None, :, None] + lz[None, None, :]
    coef = np.einsum("ia,jb,kc,abc->ijk", Vx, Vy, Vz, Ft / denom, optimize=True)
    return SpectralElementSolution3D(
        coef=coef, eval_x=ex, eval_y=ey, eval_z=ez, lift=lift
    )


def vpinn_gap_3d(problem, params, p: int = 12, n_points: int = 25) -> dict:
    """3D optimization-gap report (poisson3d family): net vs exact, direct
    solve vs exact, net vs direct solve.  The benchmark's Dirichlet data is
    non-homogeneous only on the x-faces; the separable transfinite lift
    L = [(1+x) g(b) + (1-x) g(a)]/2 interpolated from the exact boundary
    traces is built internally."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2

    if problem.name != "poisson3d":
        raise ValueError(f"vpinn_gap_3d supports poisson3d problems, got {problem.name!r}")
    cfg = problem.config
    mesh = problem.extras["mesh"]
    f_fn = problem.extras["f_rhs"]
    u_ex = problem.exact
    (a_x, b_x) = cfg.domain_x

    def lift(x, y, z):
        # transfinite in x from the exact traces on the two x-faces (the
        # benchmark's y/z faces are homogeneous; if they weren't, the
        # residual would show it)
        ua = np.asarray(u_ex(np.full_like(x, a_x), y, z))
        ub = np.asarray(u_ex(np.full_like(x, b_x), y, z))
        s = (x - a_x) / (b_x - a_x)
        return (1 - s) * ua + s * ub

    u_dir = solve_poisson3d(mesh, p, f_fn, lift_fn=lift)
    xs = np.linspace(*cfg.domain_x, n_points)
    ys = np.linspace(*cfg.domain_y, n_points)
    zs = np.linspace(*cfg.domain_z, n_points)
    XG, YG, ZG = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([XG.reshape(-1), YG.reshape(-1), ZG.reshape(-1)], axis=-1)
    u_net = predict(problem, params, pts).reshape(-1)
    u_g = u_dir(XG, YG, ZG).reshape(-1)
    u_true = np.asarray(u_ex(XG, YG, ZG)).reshape(-1)
    return {
        "rel_l2_net_vs_exact": rel_l2(u_net, u_true),
        "rel_l2_galerkin_vs_exact": rel_l2(u_g, u_true),
        "rel_l2_net_vs_galerkin": rel_l2(u_net, u_g),
    }


@dataclass(frozen=True)
class SpectralSolutionNS:
    """Steady incompressible Navier-Stokes solution on a rectangle:
    velocity components = Coons boundary lift + H0 tensor correction
    (P_N), pressure = tensor Legendre modes (P_{N-2}, zero-mean gauge)."""

    coef_u: np.ndarray  # [nx, ny] H0 correction modes
    coef_v: np.ndarray
    coef_p: np.ndarray  # [mx, my]; (0, 0) gauge mode fixed at 0
    eval_x: object  # H0 point evaluators
    eval_y: object
    lift_u: object
    lift_v: object
    domain_x: tuple
    domain_y: tuple
    newton_iters: int = 0
    residual_norm: float = 0.0

    def velocity(self, x, y):
        """(u, v) arrays of the broadcast x/y shape."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        Bx = self.eval_x(x.reshape(-1))
        By = self.eval_y(y.reshape(-1))
        u = np.einsum("ip,ij,jp->p", Bx, self.coef_u, By).reshape(x.shape)
        v = np.einsum("ip,ij,jp->p", Bx, self.coef_v, By).reshape(x.shape)
        return u + self.lift_u(x, y), v + self.lift_v(x, y)

    def pressure(self, x, y):
        """Zero-mean pressure (additive gauge left to the caller)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        (a, b), (c, d) = self.domain_x, self.domain_y
        xi = 2.0 * (x.reshape(-1) - a) / (b - a) - 1.0
        eta = 2.0 * (y.reshape(-1) - c) / (d - c) - 1.0
        Lx = np.polynomial.legendre.legvander(xi, self.coef_p.shape[0] - 1).T
        Ly = np.polynomial.legendre.legvander(eta, self.coef_p.shape[1] - 1).T
        return np.einsum("ip,ij,jp->p", Lx, self.coef_p, Ly).reshape(x.shape)

    def __call__(self, x, y):
        """Stacked (u, v, p) on a trailing component axis."""
        u, v = self.velocity(x, y)
        return np.stack([u, v, self.pressure(x, y)], axis=-1)


def solve_ns_steady(
    domain_x,
    domain_y,
    p: int,
    nu: float,
    g_fn,
    n_quad: int | None = None,
    newton_tol: float = 1e-12,
    max_newton: int = 40,
    start: np.ndarray | None = None,
) -> SpectralSolutionNS:
    """Direct solve of the steady incompressible Navier-Stokes system

        (w . grad) w + grad p = nu Lap w,   div w = 0,   w|_bd = g

    on a rectangle: single-domain P_N x P_{N-2} Legendre-Galerkin (the
    classical inf-sup-stable velocity-pressure pair) with Newton on the
    coupled saddle system.  The deterministic companion of the VPINN's
    ns_residual (ops/assembly.py) — same convective form, same IBP'd
    diffusion/pressure blocks, solved to quadrature precision.

    Velocity Dirichlet data enters through per-component transfinite Coons
    lifts (boundary traces of `g_fn` ONLY); pressure is gauge-fixed by
    dropping the constant Legendre mode (exact zero mean).  `start` warm-
    starts Newton with a previous solve's flat coefficient vector (the
    identification loop's lever).  Host float64 numpy.

    g_fn(x, y) -> (u, v) arrays of the broadcast shape.
    """
    axis_x = Interval1D.uniform(*domain_x, 1)
    axis_y = Interval1D.uniform(*domain_y, 1)
    Q = n_quad or max(2 * p + 4, 12)
    Bx1, Bx1d, wqx, xg, ex, _ = _axis_h0_quadrature(axis_x, p, Q)
    By1, By1d, wqy, yg, ey, _ = _axis_h0_quadrature(axis_y, p, Q)
    n_x, n_y = Bx1.shape[0], By1.shape[0]
    n = n_x * n_y

    # 2D tensor arrays, flattened (i, j) -> i*n_y + j, (qx, qy) -> qx*Qy + qy
    Vb = np.einsum("ip,jq->ijpq", Bx1, By1).reshape(n, -1)
    Vbx = np.einsum("ip,jq->ijpq", Bx1d, By1).reshape(n, -1)
    Vby = np.einsum("ip,jq->ijpq", Bx1, By1d).reshape(n, -1)
    wq2 = np.outer(wqx, wqy).reshape(-1)

    # P_{N-2} pressure space: Legendre tensor modes on the reference square,
    # constant (gauge) mode dropped
    xi, _w = gauss_lobatto_jacobi(Q, 0.0, 0.0)
    mx = my = p - 1  # degrees 0..p-2
    Lx = np.polynomial.legendre.legvander(xi, mx - 1).T  # [mx, Q]
    Ly = np.polynomial.legendre.legvander(xi, my - 1).T
    Pb = np.einsum("ip,jq->ijpq", Lx, Ly).reshape(mx * my, -1)[1:]  # drop (0,0)
    m = Pb.shape[0]

    gu = lambda x, y: np.asarray(g_fn(x, y)[0], dtype=np.float64)  # noqa: E731
    gv = lambda x, y: np.asarray(g_fn(x, y)[1], dtype=np.float64)  # noqa: E731
    lift_u = coons_lift(gu, domain_x, domain_y)
    lift_v = coons_lift(gv, domain_x, domain_y)
    XX, YY = np.meshgrid(xg, yg, indexing="ij")
    h = 1e-6
    Lu = lift_u(XX, YY).reshape(-1)
    Lv = lift_v(XX, YY).reshape(-1)
    Lux = ((lift_u(XX + h, YY) - lift_u(XX - h, YY)) / (2 * h)).reshape(-1)
    Luy = ((lift_u(XX, YY + h) - lift_u(XX, YY - h)) / (2 * h)).reshape(-1)
    Lvx = ((lift_v(XX + h, YY) - lift_v(XX - h, YY)) / (2 * h)).reshape(-1)
    Lvy = ((lift_v(XX, YY + h) - lift_v(XX, YY - h)) / (2 * h)).reshape(-1)

    def fields(c):
        cu, cv, cp = c[:n], c[n:2 * n], c[2 * n:]
        U = Lu + Vb.T @ cu
        V = Lv + Vb.T @ cv
        Ux, Uy = Lux + Vbx.T @ cu, Luy + Vby.T @ cu
        Vx, Vy = Lvx + Vbx.T @ cv, Lvy + Vby.T @ cv
        P = Pb.T @ cp
        return U, V, Ux, Uy, Vx, Vy, P

    def residual(c):
        U, V, Ux, Uy, Vx, Vy, P = fields(c)
        Ru = (
            Vb @ (wq2 * (U * Ux + V * Uy))
            + nu * (Vbx @ (wq2 * Ux) + Vby @ (wq2 * Uy))
            - Vbx @ (wq2 * P)
        )
        Rv = (
            Vb @ (wq2 * (U * Vx + V * Vy))
            + nu * (Vbx @ (wq2 * Vx) + Vby @ (wq2 * Vy))
            - Vby @ (wq2 * P)
        )
        Rc = Pb @ (wq2 * (Ux + Vy))
        return np.concatenate([Ru, Rv, Rc])

    Avisc = nu * ((Vbx * wq2) @ Vbx.T + (Vby * wq2) @ Vby.T)
    Bup = -(Vbx * wq2) @ Pb.T
    Bvp = -(Vby * wq2) @ Pb.T

    def jacobian(c):
        U, V, Ux, Uy, Vx, Vy, _P = fields(c)
        conv_diag = (Vb * (wq2 * U)) @ Vbx.T + (Vb * (wq2 * V)) @ Vby.T
        Juu = (Vb * (wq2 * Ux)) @ Vb.T + conv_diag + Avisc
        Juv = (Vb * (wq2 * Uy)) @ Vb.T
        Jvu = (Vb * (wq2 * Vx)) @ Vb.T
        Jvv = (Vb * (wq2 * Vy)) @ Vb.T + conv_diag + Avisc
        J = np.zeros((2 * n + m, 2 * n + m))
        J[:n, :n], J[:n, n:2 * n], J[:n, 2 * n:] = Juu, Juv, Bup
        J[n:2 * n, :n], J[n:2 * n, n:2 * n], J[n:2 * n, 2 * n:] = Jvu, Jvv, Bvp
        J[2 * n:, :n] = (Pb * wq2) @ Vbx.T
        J[2 * n:, n:2 * n] = (Pb * wq2) @ Vby.T
        return J

    c = np.zeros(2 * n + m) if start is None else np.asarray(start, dtype=np.float64).copy()
    R = residual(c)
    rnorm = float(np.linalg.norm(R))
    iters = 0
    for iters in range(1, max_newton + 1):
        dc = np.linalg.solve(jacobian(c), R)
        step = 1.0
        for _ in range(12):  # backtracking keeps Re-robustness
            c_try = c - step * dc
            R_try = residual(c_try)
            rn_try = float(np.linalg.norm(R_try))
            if rn_try < rnorm or rn_try < newton_tol:
                break
            step *= 0.5
        c, R, rnorm = c_try, R_try, rn_try
        if rnorm < newton_tol:
            break

    cp_full = np.zeros(mx * my)
    cp_full[1:] = c[2 * n:]
    return SpectralSolutionNS(
        coef_u=c[:n].reshape(n_x, n_y),
        coef_v=c[n:2 * n].reshape(n_x, n_y),
        coef_p=cp_full.reshape(mx, my),
        eval_x=ex, eval_y=ey, lift_u=lift_u, lift_v=lift_v,
        domain_x=tuple(domain_x), domain_y=tuple(domain_y),
        newton_iters=iters, residual_norm=rnorm,
    )


def vpinn_gap_kovasznay(problem, params, p: int = 24, n_points: int = 81) -> dict:
    """Optimization-gap report for the Navier-Stokes SYSTEM: net vs exact,
    direct solve vs exact, net vs direct solve — stacked (u, v, p) rel-L2
    with the direct solve's zero-mean pressure gauge aligned to the exact
    field's mean.  Boundary data enters the solver through Coons traces of
    the exact velocity only (the interior is entirely the solve's)."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2
    from hpvpinns_tpu_torch.problems.kovasznay import exact_fields

    if problem.name != "kovasznay":
        raise ValueError(
            f"vpinn_gap_kovasznay supports kovasznay problems, got {problem.name!r}"
        )
    cfg = problem.config

    def g_fn(x, y):
        u, v, _ = exact_fields(x, y, cfg.re)
        return u, v

    sol = solve_ns_steady(cfg.domain_x, cfg.domain_y, p, 1.0 / cfg.re, g_fn)
    xs = np.linspace(*cfg.domain_x, n_points)
    ys = np.linspace(*cfg.domain_y, n_points)
    XG, YG = np.meshgrid(xs, ys, indexing="ij")
    w_g = sol(XG, YG).reshape(-1, 3)
    w_true = np.stack(exact_fields(XG, YG, cfg.re), axis=-1).reshape(-1, 3)
    w_g[:, 2] += w_true[:, 2].mean() - w_g[:, 2].mean()  # pressure gauge
    pts = np.stack([XG.reshape(-1), YG.reshape(-1)], axis=-1)
    w_net = predict(problem, params, pts).reshape(-1, 3)
    return {
        "rel_l2_net_vs_exact": rel_l2(w_net, w_true),
        "rel_l2_galerkin_vs_exact": rel_l2(w_g, w_true),
        "rel_l2_net_vs_galerkin": rel_l2(w_net, w_g),
        "newton_iters": sol.newton_iters,
    }


@dataclass(frozen=True)
class SpectralSolutionNSUnsteady:
    """BDF2-in-time steady-spatial-machinery NS solution: per-step velocity
    corrections + zero-mean pressures; correction coefficients linearly
    interpolated in t (O(dt^2), consistent with BDF2), lifts evaluated
    analytically at the requested t."""

    t_grid: np.ndarray  # [n_steps + 1]
    coefs: np.ndarray  # [n_steps + 1, 2n + m] (pressure at step 0 = step 1)
    n: int  # velocity modes per component
    shape_v: tuple  # (n_x, n_y)
    shape_p: tuple  # (mx, my)
    eval_x: object
    eval_y: object
    g_fn: object  # boundary velocity (x, y, t) -> (u, v)
    domain_x: tuple
    domain_y: tuple

    def _interp(self, t):
        t = np.clip(np.asarray(t, dtype=np.float64), self.t_grid[0], self.t_grid[-1])
        k = np.clip(np.searchsorted(self.t_grid, t) - 1, 0, len(self.t_grid) - 2)
        dt = self.t_grid[k + 1] - self.t_grid[k]
        a = (t - self.t_grid[k]) / dt
        return (1 - a)[..., None] * self.coefs[k] + a[..., None] * self.coefs[k + 1]

    def velocity(self, x, y, t):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        x, y, t = np.broadcast_arrays(x, y, t)
        c = self._interp(t.reshape(-1))  # [P, 2n+m]
        n = self.n
        Bx = self.eval_x(x.reshape(-1))  # [nx, P]
        By = self.eval_y(y.reshape(-1))
        BB = np.einsum(
            "ip,jp->pij", Bx, By
        ).reshape(-1, n)  # [P, n] tensor basis at each point
        u = np.einsum("pn,pn->p", BB, c[:, :n])
        v = np.einsum("pn,pn->p", BB, c[:, n:2 * n])
        lu, lv = _coons_uv(self.g_fn, self.domain_x, self.domain_y,
                           x.reshape(-1), y.reshape(-1), t.reshape(-1))
        return (u + lu).reshape(x.shape), (v + lv).reshape(x.shape)

    def pressure(self, x, y, t):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        x, y, t = np.broadcast_arrays(x, y, t)
        cp = self._interp(t.reshape(-1))[:, 2 * self.n:]
        mx, my = self.shape_p
        full = np.zeros((cp.shape[0], mx * my))
        full[:, 1:] = cp
        (a, b), (cc, d) = self.domain_x, self.domain_y
        xi = 2.0 * (x.reshape(-1) - a) / (b - a) - 1.0
        eta = 2.0 * (y.reshape(-1) - cc) / (d - cc) - 1.0
        Lx = np.polynomial.legendre.legvander(xi, mx - 1)  # [P, mx]
        Ly = np.polynomial.legendre.legvander(eta, my - 1)
        PB = np.einsum("pi,pj->pij", Lx, Ly).reshape(-1, mx * my)
        return np.einsum("pn,pn->p", PB, full).reshape(x.shape)


def _coons_uv(g_fn, domain_x, domain_y, x, y, t):
    """Coons lift of the time-dependent velocity traces at points (x, y, t)."""
    gu = lambda xx, yy, tt: np.asarray(g_fn(xx, yy, tt)[0], dtype=np.float64)  # noqa: E731
    gv = lambda xx, yy, tt: np.asarray(g_fn(xx, yy, tt)[1], dtype=np.float64)  # noqa: E731
    out = []
    for g in (gu, gv):
        lift = coons_lift(lambda xx, yy, g=g: g(xx, yy, t), domain_x, domain_y)
        out.append(lift(x, y))
    return out


def solve_ns_unsteady(
    domain_x,
    domain_y,
    p: int,
    nu: float,
    g_fn,
    u0_fn,
    t_final: float = 1.0,
    n_steps: int = 80,
    n_quad: int | None = None,
    newton_tol: float = 1e-12,
    max_newton: int = 25,
) -> SpectralSolutionNSUnsteady:
    """Direct solve of the UNSTEADY incompressible Navier-Stokes system

        w_t + (w . grad) w + grad p = nu Lap w,   div w = 0,
        w|_bd = g(x, y, t),   w|_{t=0} = u0(x, y)

    on a rectangle: the steady solver's single-domain P_N x P_{N-2}
    spatial machinery (solve_ns_steady) marched with BDF2 (BDF1 bootstrap)
    + Newton per step.  The time-dependent Dirichlet data enters through
    per-step Coons lifts of the boundary traces; the BDF history carries
    FULL velocity fields on the quadrature grid, so the lift's time
    derivative needs no separate treatment.  Host float64 numpy — the
    deterministic companion of the taylorgreen VPINN family.

    g_fn(x, y, t) -> (u, v); u0_fn(x, y) -> (u, v).
    """
    axis_x = Interval1D.uniform(*domain_x, 1)
    axis_y = Interval1D.uniform(*domain_y, 1)
    Q = n_quad or max(2 * p + 4, 12)
    Bx1, Bx1d, wqx, xg, ex, _ = _axis_h0_quadrature(axis_x, p, Q)
    By1, By1d, wqy, yg, ey, _ = _axis_h0_quadrature(axis_y, p, Q)
    n_x, n_y = Bx1.shape[0], By1.shape[0]
    n = n_x * n_y

    Vb = np.einsum("ip,jq->ijpq", Bx1, By1).reshape(n, -1)
    Vbx = np.einsum("ip,jq->ijpq", Bx1d, By1).reshape(n, -1)
    Vby = np.einsum("ip,jq->ijpq", Bx1, By1d).reshape(n, -1)
    wq2 = np.outer(wqx, wqy).reshape(-1)

    xi, _w = gauss_lobatto_jacobi(Q, 0.0, 0.0)
    mx = my = p - 1
    Lx = np.polynomial.legendre.legvander(xi, mx - 1).T
    Ly = np.polynomial.legendre.legvander(xi, my - 1).T
    Pb = np.einsum("ip,jq->ijpq", Lx, Ly).reshape(mx * my, -1)[1:]
    m = Pb.shape[0]

    XX, YY = np.meshgrid(xg, yg, indexing="ij")
    Xf, Yf = XX.reshape(-1), YY.reshape(-1)
    h = 1e-6
    t_grid = np.linspace(0.0, t_final, n_steps + 1)

    def lift_at(t):
        """(Lu, Lv, Lux, Luy, Lvx, Lvy) on the quadrature grid at time t."""
        tt = np.full_like(Xf, t)
        out = []
        lu, lv = _coons_uv(g_fn, domain_x, domain_y, Xf, Yf, tt)
        for g_i in (0, 1):
            def lift(xq_, yq_):
                return _coons_uv(g_fn, domain_x, domain_y, xq_, yq_, tt)[g_i]
            gx = (lift(Xf + h, Yf) - lift(Xf - h, Yf)) / (2 * h)
            gy = (lift(Xf, Yf + h) - lift(Xf, Yf - h)) / (2 * h)
            out.append((gx, gy))
        return lu, lv, out[0][0], out[0][1], out[1][0], out[1][1]

    Mv = (Vb * wq2) @ Vb.T
    Avisc = nu * ((Vbx * wq2) @ Vbx.T + (Vby * wq2) @ Vby.T)
    Bup = -(Vbx * wq2) @ Pb.T
    Bvp = -(Vby * wq2) @ Pb.T
    Jcu = (Pb * wq2) @ Vbx.T
    Jcv = (Pb * wq2) @ Vby.T

    # Initial full fields on the quadrature grid.
    U0, V0 = (np.asarray(a, dtype=np.float64).reshape(-1) for a in u0_fn(Xf, Yf))
    lu0, lv0, *_ = lift_at(0.0)
    c0_u = np.linalg.solve(Mv, Vb @ (wq2 * (U0 - lu0)))
    c0_v = np.linalg.solve(Mv, Vb @ (wq2 * (V0 - lv0)))

    dt = t_final / n_steps
    coefs = np.zeros((n_steps + 1, 2 * n + m))
    coefs[0, :n], coefs[0, n:2 * n] = c0_u, c0_v
    U_prev2 = None
    U_prev = (U0, V0)
    c = coefs[0].copy()

    for k in range(n_steps):
        t1 = t_grid[k + 1]
        Lu, Lv, Lux, Luy, Lvx, Lvy = lift_at(t1)
        if U_prev2 is None:
            a0, hu, hv = 1.0, U_prev[0], U_prev[1]  # BDF1 bootstrap
        else:
            a0 = 1.5
            hu = 2.0 * U_prev[0] - 0.5 * U_prev2[0]
            hv = 2.0 * U_prev[1] - 0.5 * U_prev2[1]

        def fields(cv):
            cu_, cv_, cp_ = cv[:n], cv[n:2 * n], cv[2 * n:]
            U = Lu + Vb.T @ cu_
            V = Lv + Vb.T @ cv_
            return (U, V,
                    Lux + Vbx.T @ cu_, Luy + Vby.T @ cu_,
                    Lvx + Vbx.T @ cv_, Lvy + Vby.T @ cv_,
                    Pb.T @ cp_)

        def residual(cv):
            U, V, Ux, Uy, Vx, Vy, P = fields(cv)
            Ru = (
                Vb @ (wq2 * ((a0 * U - hu) / dt + U * Ux + V * Uy))
                + nu * (Vbx @ (wq2 * Ux) + Vby @ (wq2 * Uy))
                - Vbx @ (wq2 * P)
            )
            Rv = (
                Vb @ (wq2 * ((a0 * V - hv) / dt + U * Vx + V * Vy))
                + nu * (Vbx @ (wq2 * Vx) + Vby @ (wq2 * Vy))
                - Vby @ (wq2 * P)
            )
            Rc = Pb @ (wq2 * (Ux + Vy))
            return np.concatenate([Ru, Rv, Rc])

        def jacobian(cv):
            U, V, Ux, Uy, Vx, Vy, _P = fields(cv)
            conv_diag = (Vb * (wq2 * U)) @ Vbx.T + (Vb * (wq2 * V)) @ Vby.T
            Jt = (a0 / dt) * Mv
            Juu = Jt + (Vb * (wq2 * Ux)) @ Vb.T + conv_diag + Avisc
            Juv = (Vb * (wq2 * Uy)) @ Vb.T
            Jvu = (Vb * (wq2 * Vx)) @ Vb.T
            Jvv = Jt + (Vb * (wq2 * Vy)) @ Vb.T + conv_diag + Avisc
            J = np.zeros((2 * n + m, 2 * n + m))
            J[:n, :n], J[:n, n:2 * n], J[:n, 2 * n:] = Juu, Juv, Bup
            J[n:2 * n, :n], J[n:2 * n, n:2 * n], J[n:2 * n, 2 * n:] = Jvu, Jvv, Bvp
            J[2 * n:, :n], J[2 * n:, n:2 * n] = Jcu, Jcv
            return J

        R = residual(c)
        rnorm = float(np.linalg.norm(R))
        for _ in range(max_newton):
            dc = np.linalg.solve(jacobian(c), R)
            step = 1.0
            for _ls in range(10):
                c_try = c - step * dc
                R_try = residual(c_try)
                rn = float(np.linalg.norm(R_try))
                if rn < rnorm or rn < newton_tol:
                    break
                step *= 0.5
            c, R, rnorm = c_try, R_try, rn
            if rnorm < newton_tol:
                break
        coefs[k + 1] = c
        U_full, V_full = fields(c)[0], fields(c)[1]
        U_prev2, U_prev = U_prev, (U_full, V_full)

    # Startup pressures: the t0 pressure is never solved (the IC is
    # velocity only) and the step-1 pressure carries the BDF1 bootstrap's
    # O(dt) error — measured to be the ONLY non-O(dt^2) content in the
    # whole solution (per-time profile: 1.5e-4 at steps 0-1 vs 1e-6-class
    # from step 2 on).  Quadratic extrapolation from the clean steps
    # 2, 3, 4 replaces both (error ~ p''' (2 dt)^3, far below the march's).
    if n_steps >= 4:
        p2, p3, p4 = (coefs[k, 2 * n:] for k in (2, 3, 4))
        coefs[1, 2 * n:] = 3.0 * p2 - 3.0 * p3 + p4
        coefs[0, 2 * n:] = 6.0 * p2 - 8.0 * p3 + 3.0 * p4
    elif n_steps >= 2:
        coefs[0, 2 * n:] = 2.0 * coefs[1, 2 * n:] - coefs[2, 2 * n:]
    else:
        coefs[0, 2 * n:] = coefs[1, 2 * n:]
    return SpectralSolutionNSUnsteady(
        t_grid=t_grid, coefs=coefs, n=n, shape_v=(n_x, n_y), shape_p=(mx, my),
        eval_x=ex, eval_y=ey, g_fn=g_fn,
        domain_x=tuple(domain_x), domain_y=tuple(domain_y),
    )


def vpinn_gap_taylorgreen(problem, params, p: int = 14, n_steps: int = 120,
                          n_points: int = 41) -> dict:
    """Optimization-gap report for the unsteady NS system: net vs exact,
    direct solve vs exact, net vs direct solve — stacked (u, v, p) rel-L2
    on the problem's own test times, pressure gauge aligned per report."""
    from hpvpinns_tpu_torch.evaluate import predict, rel_l2
    from hpvpinns_tpu_torch.problems.taylorgreen import exact_fields

    if problem.name != "taylorgreen":
        raise ValueError(
            f"vpinn_gap_taylorgreen supports taylorgreen problems, got {problem.name!r}"
        )
    cfg = problem.config

    def g_fn(x, y, t):
        u, v, _ = exact_fields(x, y, t, cfg.re)
        return u, v

    def u0_fn(x, y):
        u, v, _ = exact_fields(x, y, 0.0, cfg.re)
        return u, v

    sol = solve_ns_unsteady(
        cfg.domain_x, cfg.domain_y, p, 1.0 / cfg.re, g_fn, u0_fn,
        cfg.t_final, n_steps,
    )
    xs = np.linspace(*cfg.domain_x, n_points)
    ys = np.linspace(*cfg.domain_y, n_points)
    ts = np.linspace(0.0, cfg.t_final, 5)
    TG, YG, XG = np.meshgrid(ts, ys, xs, indexing="ij")
    u_g, v_g = sol.velocity(XG, YG, TG)
    p_g = sol.pressure(XG, YG, TG)
    ut, vt, pt = exact_fields(XG, YG, TG, cfg.re)
    p_g = p_g + pt.mean() - p_g.mean()
    w_g = np.stack([u_g, v_g, p_g], axis=-1).reshape(-1, 3)
    w_true = np.stack([ut, vt, pt], axis=-1).reshape(-1, 3)
    pts = np.stack([XG.reshape(-1), YG.reshape(-1), TG.reshape(-1)], axis=-1)
    w_net = predict(problem, params, pts).reshape(-1, 3)
    return {
        "rel_l2_net_vs_exact": rel_l2(w_net, w_true),
        "rel_l2_galerkin_vs_exact": rel_l2(w_g, w_true),
        "rel_l2_net_vs_galerkin": rel_l2(w_net, w_g),
    }
