"""Adaptive hp refinement driven by a-posteriori weak-residual indicators.

Counterpart of hpvpinns_tpu/adaptive.py, with the same names and
signatures.  The loop is

    solve -> estimate (per-element weak-residual indicator)
          -> mark (Dörfler bulk criterion)
          -> refine (bisect marked elements, or raise their test orders)
          -> solve again, warm-started.

The indicator is the weak residual against the test modes beyond the
training basis (each problem's extras["enriched_residual_fn"]): one forward
pass, no exact solution.  The MLP ansatz is mesh-independent, so the
parameters carry over verbatim from round to round.  Every round builds a
new problem and trains it through `train`, on the card by default.

The adaptive_galerkin_* loops put the direct solvers of galerkin.py (host
float64 numpy/scipy) in the solve slot: no network, no optimizer.

Supports Poisson-1D (interval bisection), the 2D tensor meshes (Poisson-2D,
Helmholtz-2D, Kovasznay: axis intervals are bisected when the eta mass of
their element row/column is marked, which keeps the tensor structure the
contractions need) and the space-time families (Burgers, AdvDiff, AdvDiff-2D,
Taylor-Green).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.config import (
    AdvDiff2DConfig,
    AdvDiffConfig,
    BurgersConfig,
    Helmholtz2DConfig,
    KovasznayConfig,
    Poisson1DConfig,
    Poisson2DConfig,
    TaylorGreenConfig,
    TrainConfig,
)
from hpvpinns_tpu_torch.evaluate import evaluate as evaluate_problem
from hpvpinns_tpu_torch.galerkin import coons_lift, solve_advdiff, solve_burgers, solve_poisson1d, solve_poisson2d
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu_torch.problems import build
from hpvpinns_tpu_torch.problems.burgers import u_exact, u_initial
from hpvpinns_tpu_torch.spectral.basis import make_test_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.training import train


@dataclass
class AdaptiveResult:
    rounds: List[Dict[str, Any]]  # per round: n_elem, grid(s), eta, metrics
    problem: Any  # final Problem
    result: Any  # final TrainResult
    best_round: int = 0
    best_params: Any = None  # params of the best-rel-L2 round
    best_problem: Any = None

    @property
    def rel_l2_trajectory(self):
        return [r["rel_l2"] for r in self.rounds]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def element_indicator(problem, params, enrich: int = 4) -> np.ndarray:
    """Per-element a-posteriori error indicator (no exact solution needed),
    as numpy [E] in the problem's dtype.

    Preferred: hierarchical, the weak residual tested against the next
    `enrich` modes beyond the training basis (extras["enriched_residual_fn"]).
    The trained residual is near-orthogonal to the training test space, so
    the plain per-element loss contribution goes blind exactly where the
    solution is under-resolved; the first untrained modes see it.

    Fallback (enrich 0): eta_e = the element's variational-loss contribution
    sum_n Res[e,n]^2 / n_test[e].  Both run under torch.no_grad on the
    problem's device."""
    efn = problem.extras.get("enriched_residual_fn")
    with torch.no_grad():
        if efn is not None and enrich > 0:
            res = _host(efn(params, enrich))
            return (res.reshape(res.shape[0], -1) ** 2).mean(axis=1)
        rfn = problem.extras.get("residual_fn")
        if rfn is None:
            raise ValueError(f"problem {problem.name!r} exposes no residual_fn")
        res = _host(rfn(params, problem.data))
    n_test = _host(problem.data["elements"].n_test)
    return (res.reshape(res.shape[0], -1) ** 2).sum(axis=1) / n_test


def dorfler_mark(eta: np.ndarray, theta: float = 0.5) -> np.ndarray:
    """Bulk (Dörfler) marking: the smallest element set holding a theta
    fraction of the total indicator mass."""
    order = np.argsort(eta)[::-1]
    csum = np.cumsum(eta[order])
    k = int(np.searchsorted(csum, theta * csum[-1])) + 1
    marked = np.zeros(len(eta), dtype=bool)
    marked[order[:k]] = True
    return marked


def bisect_marked(grid: np.ndarray, marked: np.ndarray) -> tuple:
    """Insert midpoints of marked intervals; returns the refined grid."""
    out = []
    for i in range(len(grid) - 1):
        out.append(float(grid[i]))
        if marked[i]:
            out.append(float(0.5 * (grid[i] + grid[i + 1])))
    out.append(float(grid[-1]))
    return tuple(out)


def _refined_config(
    cfg, problem, eta: np.ndarray, theta: float, mode: str = "h", p_step: int = 4,
    axes: str = "x",
):
    """Next round's config.

    mode='h': bisect the marked elements (1D) / the axis intervals carrying
    marked eta mass (2D tensor mesh — tensor structure preserved).
    mode='p': raise the marked elements' test-function counts by `p_step`
    (the framework's ragged n_test_per_elem masks make this free).
    `axes` applies to space-time families only: "x" (default) marks the
    space axis, "xt" marks both.
    """
    mesh = problem.extras["mesh"]
    if isinstance(cfg, Poisson1DConfig):
        marked = dorfler_mark(eta, theta)
        if mode == "p":
            nt = (
                np.asarray(cfg.n_test_per_elem)
                if cfg.n_test_per_elem is not None
                else np.full(mesh.n_elem, cfg.n_test)
            )
            nt = np.where(marked, nt + p_step, nt)
            return dataclasses.replace(cfg, n_test_per_elem=tuple(int(v) for v in nt))
        grid = bisect_marked(mesh.grid, marked)
        return dataclasses.replace(cfg, grid=grid, n_elements=len(grid) - 1)
    if isinstance(cfg, (Poisson2DConfig, KovasznayConfig, Helmholtz2DConfig)):
        # plain 2D tensor meshes (scalar Poisson/Helmholtz; the Navier-Stokes system
        # rides the identical element layout — the [E, 3, K, R] residual's
        # equation axis is already summed into eta by element_indicator)
        Ex, Ey = mesh.shape
        eta2 = eta.reshape(Ex, Ey)  # flat order e = ex * Ey + ey
        # axis marking by the eta mass of each row/column of elements
        mx = dorfler_mark(eta2.sum(axis=1), theta)
        my = dorfler_mark(eta2.sum(axis=0), theta)
        if mode == "p":
            ntx = (
                np.asarray(cfg.n_test_x_per_elem)
                if cfg.n_test_x_per_elem is not None
                else np.full(Ex, cfg.n_test_x)
            )
            nty = (
                np.asarray(cfg.n_test_y_per_elem)
                if cfg.n_test_y_per_elem is not None
                else np.full(Ey, cfg.n_test_y)
            )
            ntx = np.where(mx, ntx + p_step, ntx)
            nty = np.where(my, nty + p_step, nty)
            return dataclasses.replace(
                cfg,
                n_test_x_per_elem=tuple(int(v) for v in ntx),
                n_test_y_per_elem=tuple(int(v) for v in nty),
            )

        def split_orders(per_elem, marked):
            # bisecting an axis interval must split its per-element test
            # order too, or an hp run's ragged arrays go stale (length
            # mismatch with the new element count)
            if per_elem is None:
                return None
            nt = np.asarray(per_elem)
            return tuple(
                int(w) for i, v in enumerate(nt) for w in ((v, v) if marked[i] else (v,))
            )

        gx = bisect_marked(mesh.axis_x.grid, mx)
        gy = bisect_marked(mesh.axis_y.grid, my)
        new = {"grid_x": gx, "grid_y": gy}
        if (sx := split_orders(cfg.n_test_x_per_elem, mx)) is not None:
            new["n_test_x_per_elem"] = sx
        if (sy := split_orders(cfg.n_test_y_per_elem, my)) is not None:
            new["n_test_y_per_elem"] = sy
        return dataclasses.replace(cfg, **new)
    if isinstance(cfg, (AdvDiff2DConfig, TaylorGreenConfig)):
        # 2D-space + time families (element axes x, y, t; flat order
        # e = (ex*Ey + ey)*Et + et).  axes="x" marks the SPACE axes (x, y);
        # axes="xt" also marks time.  The unsteady Navier-Stokes system
        # (TaylorGreenConfig) rides the identical element layout — its
        # [E, 3, M, K, R] residual's equation axis is already summed into
        # eta by element_indicator, exactly like the steady system's.
        Ex, Ey, Et = mesh.shape
        eta3 = eta.reshape(Ex, Ey, Et)
        mx = dorfler_mark(eta3.sum(axis=(1, 2)), theta)
        my = dorfler_mark(eta3.sum(axis=(0, 2)), theta)
        if mode == "p":
            def bumped(per_elem, uniform, n, marked):
                nt = (
                    np.asarray(per_elem) if per_elem is not None
                    else np.full(n, uniform)
                )
                return tuple(int(v) for v in np.where(marked, nt + p_step, nt))

            new = {
                "n_test_x_per_elem": bumped(cfg.n_test_x_per_elem, cfg.n_test_x, Ex, mx),
                "n_test_y_per_elem": bumped(cfg.n_test_y_per_elem, cfg.n_test_y, Ey, my),
            }
            if "t" in axes:
                mt = dorfler_mark(eta3.sum(axis=(0, 1)), theta)
                new["n_test_t_per_elem"] = bumped(
                    cfg.n_test_t_per_elem, cfg.n_test_t, Et, mt
                )
            return dataclasses.replace(cfg, **new)

        def split_orders(per_elem, marked):
            if per_elem is None:
                return None
            nt = np.asarray(per_elem)
            return tuple(
                int(w) for i, v in enumerate(nt) for w in ((v, v) if marked[i] else (v,))
            )

        gx = bisect_marked(mesh.axis_x.grid, mx)
        gy = bisect_marked(mesh.axis_y.grid, my)
        new = {"grid_x": gx, "grid_y": gy}
        if (sx := split_orders(cfg.n_test_x_per_elem, mx)) is not None:
            new["n_test_x_per_elem"] = sx
        if (sy := split_orders(cfg.n_test_y_per_elem, my)) is not None:
            new["n_test_y_per_elem"] = sy
        if "t" in axes:
            mt = dorfler_mark(eta3.sum(axis=(0, 1)), theta)
            new["grid_t"] = bisect_marked(mesh.axis_z.grid, mt)
            if (st := split_orders(cfg.n_test_t_per_elem, mt)) is not None:
                new["n_test_t_per_elem"] = st
        return dataclasses.replace(cfg, **new)
    if isinstance(cfg, (BurgersConfig, AdvDiffConfig)):
        # Space-time families (element axes x, t).  Default axes="x" refines
        # the SPACE axis only (the nu = 0.01/pi Burgers difficulty is a steep
        # front in x; the time axis is smooth) — this automates the
        # front-clustered grid the burgers_quality preset hand-specifies
        # (benchmarks/MEASUREMENTS.md: that one meshing decision is worth 16x in error
        # at identical budget).  axes="xt" ALSO refines the marked time
        # intervals (moving fronts / sharp transients).
        Ex, Et = mesh.shape
        eta2 = eta.reshape(Ex, Et)  # flat order e = ex * Et + et
        mx = dorfler_mark(eta2.sum(axis=1), theta)
        if mode == "p":
            # per-AXIS test-order enrichment on the existing ragged
            # n_test_*_per_elem masks (the reference's p-nonuniformity array,
            # Poisson-1D.py:268, lifted to the space-time tensor basis)
            ntx = (
                np.asarray(cfg.n_test_x_per_elem)
                if cfg.n_test_x_per_elem is not None
                else np.full(Ex, cfg.n_test_x)
            )
            ntx = np.where(mx, ntx + p_step, ntx)
            new = {"n_test_x_per_elem": tuple(int(v) for v in ntx)}
            if "t" in axes:
                mt = dorfler_mark(eta2.sum(axis=0), theta)
                ntt = (
                    np.asarray(cfg.n_test_t_per_elem)
                    if cfg.n_test_t_per_elem is not None
                    else np.full(Et, cfg.n_test_t)
                )
                ntt = np.where(mt, ntt + p_step, ntt)
                new["n_test_t_per_elem"] = tuple(int(v) for v in ntt)
            return dataclasses.replace(cfg, **new)
        gx = bisect_marked(mesh.axis_x.grid, mx)
        new = {"grid_x": gx, "n_elements_x": len(gx) - 1}
        # bisecting an axis interval splits the per-element order arrays too
        if cfg.n_test_x_per_elem is not None:
            ntx = np.asarray(cfg.n_test_x_per_elem)
            new["n_test_x_per_elem"] = tuple(
                int(w) for i, v in enumerate(ntx) for w in ((v, v) if mx[i] else (v,))
            )
        if "t" in axes:
            mt = dorfler_mark(eta2.sum(axis=0), theta)
            gt = bisect_marked(mesh.axis_y.grid, mt)
            new.update(grid_t=gt, n_elements_t=len(gt) - 1)
            if cfg.n_test_t_per_elem is not None:
                ntt = np.asarray(cfg.n_test_t_per_elem)
                new["n_test_t_per_elem"] = tuple(
                    int(w) for i, v in enumerate(ntt) for w in ((v, v) if mt[i] else (v,))
                )
        return dataclasses.replace(cfg, **new)
    raise TypeError(
        "adaptive refinement supports Poisson/Burgers/AdvDiff/Kovasznay/"
        f"TaylorGreen configs, got {type(cfg).__name__}"
    )


def adaptive_solve(
    cfg,
    rounds: int = 3,
    theta: float = 0.5,
    train_cfg: Optional[TrainConfig] = None,
    mesh=None,
    build_fn=None,
    mode: str = "h",
    p_step: int = 4,
    axes: str = "x",
    lr_decay: float = 0.5,
    budget_growth: float = 1.0,
    verbose: bool = False,
) -> AdaptiveResult:
    """Solve-estimate-mark-refine for `rounds` rounds, warm-starting the
    network parameters across rounds.  Returns the per-round metric history,
    the final trained problem, and the best round's parameters.

    `lr_decay` shrinks the Adam learning rate each round (round r trains at
    lr * lr_decay^r): a warm start sits near a minimum, and re-kicking Adam
    at the full rate destabilizes it (rel-L2 regressions in float32,
    benchmarks/MEASUREMENTS.md).  `budget_growth` scales BOTH optimization
    budgets each round (round r trains for iterations * budget_growth^r):
    refinement raises the optimization difficulty with the element count,
    and a fixed per-round budget is the measured cause of late-round
    regressions on the steep 1D problem (benchmarks/MEASUREMENTS.md) —
    growth ~1.5-2 keeps rounds comparable.
    `build_fn(cfg) -> Problem` overrides the problem builder
    (custom manufactured solutions via functools.partial(build, u_fn=...));
    the default builds on the card, functools.partial(build, device="cpu")
    on the CPU.  Each round builds a new problem, so under
    deriv_mode="pallas" each round plans its kernel launches and captures its
    training graphs anew; the previous round's graphs are freed by train."""
    build_fn = build_fn or build
    params = None
    records: List[Dict[str, Any]] = []
    problem = res = None
    best = (np.inf, 0, None, None)  # (rel_l2, round, params, problem)
    base_tc = train_cfg or cfg.train
    for r in range(rounds):
        problem = build_fn(cfg)
        tc = dataclasses.replace(
            base_tc,
            learning_rate=base_tc.learning_rate * (lr_decay**r),
            iterations=max(1, int(round(base_tc.iterations * budget_growth**r))),
            lbfgs_iterations=int(round(base_tc.lbfgs_iterations * budget_growth**r)),
            # per-round loss-min snapshot (fraction 0.0 = over the whole
            # round): late L-BFGS steps can blow up a warm-started f32 run,
            # and the next round must not inherit the blow-up
            best_snapshot_fraction=(
                base_tc.best_snapshot_fraction
                if base_tc.best_snapshot_fraction is not None
                else 0.0
            ),
        )
        res = train(problem, tc, mesh=mesh, params=params, verbose=verbose)
        params = res.eval_params  # best-of-round, not last
        eta = element_indicator(problem, res.eval_params)
        metrics = evaluate_problem(problem, res.eval_params)
        mesh_obj = problem.extras["mesh"]
        rec = {
            "round": r,
            "n_elem": int(eta.shape[0]),
            "eta": [float(v) for v in eta],
            "final_loss": res.final_aux.get("loss"),
            "iterations": tc.iterations,
            "lbfgs_iterations": tc.lbfgs_iterations,
            **metrics,
        }
        if hasattr(mesh_obj, "grid"):
            rec["grid"] = [float(g) for g in mesh_obj.grid]
        else:
            rec["grid_x"] = [float(g) for g in mesh_obj.axis_x.grid]
            rec["grid_y"] = [float(g) for g in mesh_obj.axis_y.grid]
            if hasattr(mesh_obj, "axis_z"):
                rec["grid_t"] = [float(g) for g in mesh_obj.axis_z.grid]
        rec["n_test_per_elem"] = [
            int(v) for v in _host(problem.data["elements"].n_test)
        ]
        if "epsilon" in res.final_aux:
            # inverse families: track the identified coefficient per round
            edm = problem.extras.get("eps_domain_mean")
            with torch.no_grad():
                rec["epsilon"] = (
                    float(edm(res.eval_params)) if edm
                    else float(res.final_aux["epsilon"])
                )
            rec["eps_true"] = float(problem.extras["eps_true"])
        if "nu" in res.final_aux:
            # inverse Navier-Stokes families: track the viscosity per round
            rec["nu"] = float(res.final_aux["nu"])
            rec["nu_true"] = float(problem.extras["nu_true"])
        records.append(rec)
        if metrics["rel_l2"] < best[0]:
            best = (metrics["rel_l2"], r, res.eval_params, problem)
        if verbose:
            print(
                f"adapt round {r}: E={rec['n_elem']}, rel_l2={metrics['rel_l2']:.3e}, "
                f"eta_max/min={eta.max() / max(eta.min(), 1e-300):.1f}"
            )
        if r < rounds - 1:
            # mode="hp": alternate h (even rounds) and p (odd rounds) —
            # bisect where the indicator bites, then enrich the orders there.
            round_mode = mode if mode in ("h", "p") else ("h" if r % 2 == 0 else "p")
            cfg = _refined_config(
                cfg, problem, eta, theta, mode=round_mode, p_step=p_step, axes=axes
            )
    return AdaptiveResult(
        rounds=records, problem=problem, result=res,
        best_round=best[1], best_params=best[2], best_problem=best[3],
    )


def adaptive_galerkin_1d(
    cfg,
    rounds: int = 5,
    theta: float = 0.7,
    p: int = 12,
    enrich: int = 4,
    build_fn=None,
):
    """Classical adaptive spectral-element refinement: solve-estimate-mark-
    refine with the DIRECT Galerkin solver (galerkin.solve_poisson1d) in the
    solve slot — no network, no optimizer, no warm-start pathology.

    This closes the measured round>=1 regression of the warm-started VPINN
    loop on the steep 1D problem for the linear families: every round's
    solution is the exact minimizer on its mesh, so the ENERGY error is
    monotone by Galerkin optimality under nested refinement (measured
    3.15 -> 2.37 -> 0.93 across the first bisections).  rel-L2 tracks it —
    5.5e-2 -> 2.9e-5 over 5 rounds at theta=0.7 — but can transiently blip
    when a Dörfler tie is half-marked on an under-resolved layer
    (Aubin-Nitsche pollution; measured at theta=0.5, energy still
    decreasing), hence the 0.7 default.  The VPINN adaptive loop
    (adaptive_solve) remains the tool for problems without assembled
    systems.

    The indicator is the same hierarchical principle as
    element_indicator: the weak residual of the solved u against the next
    `enrich` bubble modes beyond the solution space (a Galerkin solution is
    exactly orthogonal to its own test space).

    Returns a list of per-round records {grid, n_elem, eta, rel_l2?}.
    """
    if not isinstance(cfg, Poisson1DConfig):
        raise TypeError("adaptive_galerkin_1d supports Poisson1DConfig")
    problem = (build_fn or build)(cfg)
    f_fn = problem.extras["f_rhs"]
    u_ex = problem.exact
    a_dom, b_dom = cfg.domain
    bc = (float(np.asarray(u_ex(np.array(a_dom)))), float(np.asarray(u_ex(np.array(b_dom)))))

    grid = (
        np.asarray(problem.extras["mesh"].grid, dtype=np.float64)
        if cfg.grid is not None or cfg.n_elements > 1
        else np.linspace(a_dom, b_dom, 3)
    )
    Q = 2 * (p + enrich) + 10
    xi, w = gauss_lobatto_jacobi(Q, 0.0, 0.0)
    tb = make_test_basis(p - 1 + enrich, xi)
    xs_err = np.linspace(a_dom, b_dom, 4001)
    u_true = np.asarray(u_ex(xs_err)).reshape(-1)

    records = []
    for r in range(rounds):
        mesh = Interval1D(grid)
        sol = solve_poisson1d(mesh, p, f_fn, bc)
        xe = mesh.map_points(xi)
        jac = mesh.jacobians
        eta = np.zeros(mesh.n_elem)
        for e in range(mesh.n_elem):
            up = sol.derivative(xe[e])
            fv = np.asarray(f_fn(xe[e])).reshape(-1)
            for n in range(p - 1, p - 1 + enrich):
                # a(u_h, phi_n) - (f, phi_n): the d/dx jacobians cancel in
                # the stiffness term; the load term carries jac_e
                res = np.sum(w * up * tb.dphi[n]) - jac[e] * np.sum(w * fv * tb.phi[n])
                eta[e] += res**2
        rel = float(
            np.linalg.norm(sol(xs_err) - u_true) / np.linalg.norm(u_true)
        )
        records.append({
            "round": r,
            "p": int(p),
            "n_elem": int(mesh.n_elem),
            "grid": [float(g) for g in grid],
            "eta": [float(v) for v in eta],
            "rel_l2": rel,
        })
        if r < rounds - 1:
            marked = dorfler_mark(eta, theta)
            grid = np.asarray(bisect_marked(mesh.grid, marked))
    return records


def adaptive_galerkin_2d(
    cfg,
    rounds: int = 4,
    theta: float = 0.6,
    p: int = 8,
    enrich: int = 2,
    build_fn=None,
):
    """2D classical adaptive spectral elements: solve-estimate-mark-refine
    with galerkin.solve_poisson2d in the solve slot and a p-ENRICHMENT
    indicator (eta_e = the element L2 mass of u_{p+enrich} - u_p — error
    estimation by hierarchical comparison; two direct solves per round).
    Tensor structure preserved by per-axis Dörfler marking, as in the VPINN
    loop.  Monotone for the same reason as the 1D variant.

    Returns per-round records {grid_x, grid_y, n_elem, eta, rel_l2}.
    """
    if not isinstance(cfg, Poisson2DConfig):
        raise TypeError("adaptive_galerkin_2d supports Poisson2DConfig")
    problem = (build_fn or build)(cfg)
    f_fn = problem.extras["f_rhs"]
    u_ex = problem.exact
    lift = coons_lift(u_ex, cfg.domain_x, cfg.domain_y)

    mesh = problem.extras["mesh"]
    gx = np.asarray(mesh.axis_x.grid, dtype=np.float64)
    gy = np.asarray(mesh.axis_y.grid, dtype=np.float64)

    xq, wq = gauss_lobatto_jacobi(10, 0.0, 0.0)
    n_err = 81
    xs = np.linspace(*cfg.domain_x, n_err)
    ys = np.linspace(*cfg.domain_y, n_err)
    XE, YE = np.meshgrid(xs, ys, indexing="ij")
    u_true = np.asarray(u_ex(XE, YE), dtype=np.float64)

    records = []
    for r in range(rounds):
        m = TensorMesh2D(axis_x=Interval1D(gx), axis_y=Interval1D(gy))
        sol_p = solve_poisson2d(m, p, f_fn, lift_fn=lift)
        sol_q = solve_poisson2d(m, p + enrich, f_fn, lift_fn=lift)
        # per-element L2 mass of the enrichment difference
        Ex, Ey = m.shape
        eta = np.zeros((Ex, Ey))
        Xq = m.axis_x.map_points(xq)  # [Ex, Q]
        Yq = m.axis_y.map_points(xq)  # [Ey, Q]
        jx, jy = m.axis_x.jacobians, m.axis_y.jacobians
        for ex in range(Ex):
            for ey in range(Ey):
                XX, YY = np.meshgrid(Xq[ex], Yq[ey], indexing="ij")
                d = sol_q(XX, YY) - sol_p(XX, YY)
                eta[ex, ey] = jx[ex] * jy[ey] * np.einsum(
                    "q,r,qr->", wq, wq, d * d
                )
        u_h = sol_p(XE, YE)
        rel = float(np.linalg.norm(u_h - u_true) / np.linalg.norm(u_true))
        records.append({
            "round": r,
            "p": int(p),
            "n_elem": int(Ex * Ey),
            "grid_x": [float(g) for g in gx],
            "grid_y": [float(g) for g in gy],
            "eta": [float(v) for v in eta.reshape(-1)],
            "rel_l2": rel,
        })
        if r < rounds - 1:
            mx = dorfler_mark(eta.sum(axis=1), theta)
            my = dorfler_mark(eta.sum(axis=0), theta)
            gx = np.asarray(bisect_marked(gx, mx))
            gy = np.asarray(bisect_marked(gy, my))
    return records


def adaptive_galerkin_advdiff(
    cfg,
    rounds: int = 4,
    theta: float = 0.7,
    p: int = 16,
    enrich: int = 4,
    n_eval_t: int = 11,
    *,
    device=None,
):
    """Space-axis adaptive refinement for the space-time advdiff family with
    the DIRECT solver (galerkin.solve_advdiff) in the loop and the
    p-enrichment indicator (space-time L2 mass of u_{p+enrich} - u_p per
    x-element, integrated over a uniform time sample).  Forward problems
    only (eps frozen at the problem's truth).  Monotone in practice for the
    same Galerkin-optimality reason as the Poisson loops; resolves the
    outflow layer the benchmark develops at the right wall.

    Returns per-round records {grid_x, n_elem, eta, rel_l2}.  `device`:
    where the problem (its exact solution and data) is built, default the
    card.
    """
    if not isinstance(cfg, AdvDiffConfig):
        raise TypeError("adaptive_galerkin_advdiff supports AdvDiffConfig")
    cfg = dataclasses.replace(cfg, inverse=False)
    problem = build(cfg) if device is None else build(cfg, device=device)  # `build`: the module's hook
    exact = problem.exact
    eps = problem.extras.get("epsilon_fn") or problem.extras["eps_true"]
    vfn = problem.extras.get("velocity_fn")
    vel = vfn if vfn is not None else cfg.velocity
    f_fn = problem.extras.get("f_rhs")
    a_dom, b_dom = cfg.domain_x
    u0 = lambda x: np.asarray(  # noqa: E731
        exact(x.reshape(-1, 1), np.zeros((x.size, 1)))
    ).reshape(x.shape)

    grid = np.linspace(a_dom, b_dom, 3)
    xq, wq = gauss_lobatto_jacobi(12, 0.0, 0.0)
    ts = np.linspace(0.0, cfg.t_final, n_eval_t)
    xs_err = np.linspace(a_dom, b_dom, 401)
    XE, TE = np.meshgrid(xs_err, ts, indexing="ij")
    u_true = np.asarray(exact(XE.reshape(-1, 1), TE.reshape(-1, 1))).reshape(XE.shape)

    records = []
    for r in range(rounds):
        axis = Interval1D(grid)
        sol_p = solve_advdiff(axis, p, u0, eps, vel, f_fn=f_fn)
        sol_q = solve_advdiff(axis, p + enrich, u0, eps, vel, f_fn=f_fn)
        Xq = axis.map_points(xq)  # [E, Q]
        jac = axis.jacobians
        eta = np.zeros(axis.n_elem)
        for e in range(axis.n_elem):
            XX, TT = np.meshgrid(Xq[e], ts, indexing="ij")
            d = sol_q(XX, TT) - sol_p(XX, TT)
            eta[e] = jac[e] * np.einsum("q,qt->", wq, d * d) / n_eval_t
        u_h = sol_p(XE, TE)
        rel = float(np.linalg.norm(u_h - u_true) / np.linalg.norm(u_true))
        records.append({
            "round": r,
            "p": int(p),
            "n_elem": int(axis.n_elem),
            "grid_x": [float(g) for g in grid],
            "eta": [float(v) for v in eta],
            "rel_l2": rel,
        })
        if r < rounds - 1:
            marked = dorfler_mark(eta, theta)
            grid = np.asarray(bisect_marked(axis.grid, marked))
    return records


def adaptive_galerkin_burgers(
    cfg,
    rounds: int = 5,
    theta: float = 0.7,
    p: int = 12,
    enrich: int = 4,
    n_steps: int = 400,
    n_eval_t: int = 11,
):
    """NONLINEAR classical adaptive loop: solve-estimate-mark-refine with
    galerkin.solve_burgers (BDF2+Newton) in the solve slot and the
    p-enrichment indicator.  Measured on the nu = 0.01/pi benchmark from
    four uniform elements: rel-L2(t=1) 2.3e-2 -> 7.2e-6 over 5 rounds,
    every inserted boundary geometrically zooming into the x = 0 front —
    the loop DISCOVERS a finer version of the hand-specified
    BURGERS_SOLVER_GRID with no meshing knowledge.

    Returns per-round records {grid_x, n_elem, eta, rel_l2} (rel-L2 at
    t = t_final vs Cole-Hopf).
    """
    if not isinstance(cfg, BurgersConfig):
        raise TypeError("adaptive_galerkin_burgers supports BurgersConfig")
    nu, T = cfg.nu, cfg.t_final
    a_dom, b_dom = cfg.domain_x
    grid = np.linspace(a_dom, b_dom, 5)
    xq, wq = gauss_lobatto_jacobi(12, 0.0, 0.0)
    ts = np.linspace(0.0, T, n_eval_t)
    xs = np.linspace(a_dom, b_dom, 201)
    ue = u_exact(xs, np.full_like(xs, T), nu).reshape(-1)

    records = []
    for r in range(rounds):
        axis = Interval1D(grid)
        sp = solve_burgers(axis, p, u_initial, nu, T, n_steps)
        sq = solve_burgers(axis, p + enrich, u_initial, nu, T, n_steps)
        Xq = axis.map_points(xq)
        jac = axis.jacobians
        eta = np.zeros(axis.n_elem)
        for e in range(axis.n_elem):
            XX, TT = np.meshgrid(Xq[e], ts, indexing="ij")
            d = sq(XX, TT) - sp(XX, TT)
            eta[e] = jac[e] * np.einsum("q,qt->", wq, d * d) / n_eval_t
        rel = float(
            np.linalg.norm(sp(xs, np.full_like(xs, T)) - ue) / np.linalg.norm(ue)
        )
        records.append({
            "round": r,
            "p": int(p),
            "n_elem": int(axis.n_elem),
            "grid_x": [float(g) for g in grid],
            "eta": [float(v) for v in eta],
            "rel_l2": rel,
        })
        if r < rounds - 1:
            marked = dorfler_mark(eta, theta)
            grid = np.asarray(bisect_marked(axis.grid, marked))
    return records
