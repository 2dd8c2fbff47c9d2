"""Unsteady incompressible Navier-Stokes: the Taylor-Green vortex.

Counterpart of hpvpinns_tpu/problems/taylorgreen.py.  A time-dependent
system: one (x, y, t) -> (u, v, p) ansatz is trained against the stacked weak
residual of x/y-momentum and continuity on the space-time tensor machinery
(ops/assembly.py::ns_unsteady_residual; time the slowest element axis, as in
problems/advdiff2d.py), its derivative fields from the JVP engine
(ops/fields.py::vector_fields_3d).

Exact solution (Taylor & Green 1937), for nu = 1/Re:

    u = -cos(x) sin(y) e^{-2 nu t}
    v =  sin(x) cos(y) e^{-2 nu t}
    p = -(cos(2x) + cos(2y))/4 e^{-4 nu t}

Inverse mode: nu = params["pde"]["nu"] is trainable and identified from
interior space-time (u, v) sensors.  The exact solution for the boundary,
sensor, anchor, gauge and test data is float64 numpy on the host; what runs
in the loss (the space-time lift, the envelope, the gauge penalty) is torch
operations on device tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import TaylorGreenConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh3D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import ns_unsteady_residual, variational_loss
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_composite_apply, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_3d, build_enriched_3d, make_weighted_basis
from hpvpinns_tpu_torch.problems.kovasznay import coons_lift
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_box, lhs_interval

N_QUAD_ZERO_MEAN = 16  # GLL points per space axis of the zero-mean gauge's slice means


def exact_fields(x, y, t, re: float):
    """(u, v, p) of the Taylor-Green solution, float64 host math, each of the
    broadcast shape of x, y and t."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    nu = 1.0 / re
    e = np.exp(-2.0 * nu * t)
    u = -np.cos(x) * np.sin(y) * e
    v = np.sin(x) * np.cos(y) * e
    p = -0.25 * (np.cos(2.0 * x) + np.cos(2.0 * y)) * e**2
    return np.broadcast_arrays(u, v, p)


def exact_stacked(x, y, t, re: float):
    """Exact (u, v, p) stacked on a trailing component axis [..., 3]."""
    return np.stack(exact_fields(x, y, t, re), axis=-1)


def exact_uv(re: float):
    """The exact velocity pair as torch maps (x, y, t) -> u and -> v (the
    hard-BC lift's data, differentiated by the JVP engine)."""
    nu = 1.0 / re

    def u(x, y, t):
        return -torch.cos(x) * torch.sin(y) * torch.exp(-2.0 * nu * t)

    def v(x, y, t):
        return torch.sin(x) * torch.cos(y) * torch.exp(-2.0 * nu * t)

    return u, v


def coons_lift_spacetime(g_fn, domain_x, domain_y, t_final, t_start: float = 0.0, g_ic_fn=None):
    """The space-time transfinite interpolant of g's values on the five data
    faces of [a, b] x [c, d] x [t0, T], the four side walls (all t) and the
    t = t0 face, in torch operations:

        L(x, y, t) = C_xy[g(., ., t)](x, y) + (1 - tau) (g0(x, y) - C_xy[g0](x, y)),
        tau = (t - t0) / (T - t0),

    C_xy the 2D Coons interpolant at frozen t and g0 the initial face:
    `g_ic_fn(x, y)` where given (a previous slab's ansatz at the interface
    time, in a hard-BC time march), else g at t0.  The correction vanishes
    on the side walls for any g0 and restores the initial face at t = t0;
    the t = T face carries no data.  C_xy is problems/kovasznay.py's
    coons_lift."""
    def coons(h_fn, x, y):
        return coons_lift(h_fn, domain_x, domain_y)(x, y)

    span = t_final - t_start

    def lift(x, y, t):
        if g_ic_fn is not None:
            g0 = g_ic_fn
        else:
            def g0(xx, yy):
                return g_fn(xx, yy, torch.full_like(xx, t_start))
        tau = (t - t_start) / span
        return coons(lambda xx, yy: g_fn(xx, yy, t), x, y) + (1.0 - tau) * (g0(x, y) - coons(g0, x, y))

    return lift


def training_data(cfg: TaylorGreenConfig, rng: np.random.Generator, ic_fn=None):
    """LHS points on the four side walls and the t = t_start face with the
    exact (u, v, p), drawn from `rng` in the JAX package's order:
    (Xb [5n, 3], wb [5n, 3]); the caller drops p when cfg.bc_pressure is
    False.  `ic_fn(xy) -> [n, 3]` (host numpy, (u, v, p) columns) replaces
    the initial face's values: a previous time slab's state."""
    T0, T = cfg.t_start, cfg.t_final
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    pts = []
    for fixed_axis, lo_hi, free in ((0, (xl, xr), [(yl, yr), (T0, T)]), (1, (yl, yr), [(xl, xr), (T0, T)])):
        for val in lo_hi:
            pts.append(np.insert(lhs_box(free, n, rng), fixed_axis, val, axis=1))
    xy0 = lhs_box([(xl, xr), (yl, yr)], n, rng)
    pts.append(np.hstack([xy0, np.full((n, 1), T0)]))
    Xb = np.concatenate(pts)
    vals = exact_stacked(Xb[:, 0], Xb[:, 1], Xb[:, 2], cfg.re)
    if ic_fn is not None:
        vals = vals.copy()
        vals[4 * n:] = np.asarray(ic_fn(xy0)).reshape(n, 3)
    return Xb, vals


def sensor_data(cfg: TaylorGreenConfig, rng: np.random.Generator):
    """Interior space-time (u, v) velocity sensors (inverse mode)."""
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    pts = lhs_box([(xl, xr), (yl, yr), (cfg.t_start, cfg.t_final)], cfg.n_sensors, rng)
    u, v, _ = exact_fields(pts[:, 0], pts[:, 1], pts[:, 2], cfg.re)
    vals = np.stack([u, v], axis=-1)
    if cfg.sensor_noise > 0.0:
        vals = vals + cfg.sensor_noise * rng.standard_normal(vals.shape)
    return pts, vals


def zero_mean_points(cfg: TaylorGreenConfig):
    """The zero-mean gauge's host precompute (float64): the points [K*Q, 3]
    of K = n_zero_mean_t time slices of a 16 x 16 GLL grid, the normalized
    quadrature weights [Q] and the exact slice means of p [K]."""
    xg, wg = gauss_lobatto_jacobi(N_QUAD_ZERO_MEAN, 0.0, 0.0)
    xs = 0.5 * (xg + 1.0) * (cfg.domain_x[1] - cfg.domain_x[0]) + cfg.domain_x[0]
    ys = 0.5 * (xg + 1.0) * (cfg.domain_y[1] - cfg.domain_y[0]) + cfg.domain_y[0]
    W2 = np.outer(wg, wg)
    w_norm = (W2 / W2.sum()).reshape(-1)
    YZ, XZ = np.meshgrid(ys, xs, indexing="ij")
    t_zm = np.linspace(cfg.t_start, cfg.t_final, cfg.n_zero_mean_t + 1)[1:]
    shape = (len(t_zm), w_norm.size)
    pts = np.stack([np.broadcast_to(XZ.reshape(-1), shape), np.broadcast_to(YZ.reshape(-1), shape),
                    np.broadcast_to(t_zm[:, None], shape)], axis=-1)
    _, _, p_ex = exact_fields(pts[..., 0], pts[..., 1], pts[..., 2], cfg.re)
    return pts.reshape(-1, 3), w_norm, p_ex @ w_norm


def build(
    cfg: TaylorGreenConfig,
    rng: np.random.Generator | None = None,
    ic_fn=None,
    ic_lift_fns=None,
    *,
    device=None,
) -> Problem:
    """The Taylor-Green problem on `device` (default: the card; pass
    device="cpu" for the CPU).  The positional arguments are the JAX
    package's: `rng` draws the boundary points, then the anchor times, then
    the sensors; `ic_fn(xy) -> [n, 3]` (host numpy) gives the initial face's
    values in place of the exact vortex; `ic_lift_fns`, a pair of torch maps
    (x, y) -> [n, 1], gives the hard-BC lift's initial u and v faces (a time
    march hands both from the previous slab; cfg.hard_bc only).  The
    derivative fields come from the JVP engine whatever cfg.deriv_mode says,
    as in the JAX package."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    if cfg.hard_bc and ic_fn is not None and ic_lift_fns is None:
        raise ValueError(
            "hard_bc's space-time lift interpolates the analytic vortex on "
            "the t = t_start face; a handed-off ic_fn needs the matching "
            "traceable ic_lift_fns pair so the lift carries the SAME "
            "predicted state (training/timemarch.py constructs both)"
        )
    if ic_lift_fns is not None and not cfg.hard_bc:
        raise ValueError("ic_lift_fns is a hard-BC lift hook; set hard_bc=True")
    if cfg.inverse and ic_fn is not None:
        raise ValueError(
            "ic_fn marches the FORWARD problem (an inverse run's sensors "
            "live on the global horizon); set inverse=False"
        )

    mesh = TensorMesh3D(
        axis_x=Interval1D.grid_or_uniform(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
        axis_y=Interval1D.grid_or_uniform(cfg.grid_y, *cfg.domain_y, cfg.n_elements_y),
        axis_z=Interval1D.grid_or_uniform(cfg.grid_t, cfg.t_start, cfg.t_final, cfg.n_elements_t),
    )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = cfg.n_test_x_per_elem if cfg.n_test_x_per_elem is not None else cfg.n_test_x
    nty = cfg.n_test_y_per_elem if cfg.n_test_y_per_elem is not None else cfg.n_test_y
    ntt = cfg.n_test_t_per_elem if cfg.n_test_t_per_elem is not None else cfg.n_test_t

    def on_device(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    eq_sel = None
    if cfg.p_test_enrich > 0:
        # the momentum rows (the equations that see grad p) get p_test_enrich
        # more test modes per axis; continuity keeps the base orders through
        # an equation-selective mask over the extra modes
        if any(v is not None for v in (cfg.n_test_x_per_elem, cfg.n_test_y_per_elem, cfg.n_test_t_per_elem)):
            raise ValueError("p_test_enrich does not compose with per-element test orders")
        e = int(cfg.p_test_enrich)
        bx0, by0, bt0 = cfg.n_test_x, cfg.n_test_y, cfg.n_test_t
        ntx, nty, ntt = bx0 + e, by0 + e, bt0 + e
        sel = np.ones((3, ntt, nty, ntx))
        sel[2] = 0.0
        sel[2, :bt0, :by0, :bx0] = 1.0  # continuity: the base block only
        eq_sel = on_device(sel)
    nx_max, ny_max, nt_max = (int(np.max(v)) for v in (ntx, nty, ntt))
    bx = make_weighted_basis(nx_max, xq, wq, dtype, device)
    by = make_weighted_basis(ny_max, xq, wq, dtype, device)
    bt = make_weighted_basis(nt_max, xq, wq, dtype, device)
    elems = build_elements_3d(mesh, xq, wq, None, ntx, nty, ntt, dtype, device)

    Xb, wb_full = training_data(cfg, rng, ic_fn=ic_fn)
    ub = wb_full if cfg.bc_pressure else wb_full[:, :2]
    data = {"elements": elems, "basis_x": bx, "basis_y": by, "basis_t": bt, "xb": on_device(Xb), "ub": on_device(ub)}
    if not cfg.bc_pressure:
        # a pressure anchor curve: the unsteady gauge is a free function of t,
        # so the anchor is one spatial point at n_anchor LHS times
        ta = lhs_interval(cfg.t_start, cfg.t_final, cfg.n_anchor, rng).reshape(-1)
        xa = np.stack([np.full_like(ta, cfg.domain_x[0]), np.full_like(ta, cfg.domain_y[0]), ta], axis=-1)
        _, _, pa = exact_fields(xa[:, 0], xa[:, 1], xa[:, 2], cfg.re)
        data["x_anchor"] = on_device(xa)
        data["p_anchor"] = on_device(pa.reshape(-1, 1))
    if cfg.inverse:
        Xs, us = sensor_data(cfg, rng)
        data["xs"], data["us"] = on_device(Xs), on_device(us)
    if cfg.p_zero_mean_weight > 0.0:
        # the zero-mean-per-time-slice gauge: p's spatial quadrature mean at
        # n_zero_mean_t slices pinned to the exact slice mean (0 on the
        # standard [0, pi]^2 box)
        x_zm, w_zm_q, p_mean = zero_mean_points(cfg)
        data["x_zeromean"] = on_device(x_zm)
        data["w_zeromean"] = on_device(w_zm_q)
        data["p_mean_exact"] = on_device(p_mean)  # [K]

    var_form, wb_weight, wa = cfg.var_form, cfg.lossb_weight, cfg.p_anchor_weight
    nu_true = 1.0 / cfg.re
    eqw = on_device(cfg.eq_weights)[None, :, None, None, None] if cfg.eq_weights is not None else None

    def weighted(res):
        return res if eqw is None else res * eqw

    def mask_eq(res):
        # the equation-selective p_test_enrich mask
        return res if eq_sel is None else res * eq_sel[None]

    w_zm, n_zm = cfg.p_zero_mean_weight, cfg.n_zero_mean_t

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)

    if cfg.hard_bc:
        if not cfg.bc_pressure:
            raise ValueError(
                "hard_bc requires bc_pressure=True: with (u, v) exact by "
                "construction the boundary p data is what fixes the gauge"
            )
        ue_fn, ve_fn = exact_uv(cfg.re)
        u_ic, v_ic = ic_lift_fns if ic_lift_fns is not None else (None, None)
        lift_u = coons_lift_spacetime(ue_fn, cfg.domain_x, cfg.domain_y, cfg.t_final, t_start=cfg.t_start,
                                      g_ic_fn=u_ic)
        lift_v = coons_lift_spacetime(ve_fn, cfg.domain_x, cfg.domain_y, cfg.t_final, t_start=cfg.t_start,
                                      g_ic_fn=v_ic)
        (xa_, xb_), (ya_, yb_) = cfg.domain_x, cfg.domain_y
        sx = ((xb_ - xa_) / 2.0) ** 2
        sy = ((yb_ - ya_) / 2.0) ** 2
        T0_, T_ = cfg.t_start, cfg.t_final

        def lift(X):
            x, y, t = X[:, 0:1], X[:, 1:2], X[:, 2:3]
            return torch.cat([lift_u(x, y, t), lift_v(x, y, t), torch.zeros_like(x)], dim=-1)

        def envelope(X):
            # the velocity envelope vanishes on the five data faces and is 1
            # at the domain's center at t = T; p is not enveloped
            x, y, t = X[:, 0:1], X[:, 1:2], X[:, 2:3]
            bub = ((x - xa_) * (xb_ - x) / sx) * ((y - ya_) * (yb_ - y) / sy)
            bub = bub * ((t - T0_) / (T_ - T0_))
            return torch.cat([bub, bub, torch.ones_like(bub)], dim=-1)

        make_w_fn = make_composite_apply(spec, lift, envelope)
    else:

        def make_w_fn(params):
            return lambda X: mlp_apply(spec, params["net"], X)

    def nu_of(params):
        return params["pde"]["nu"] if cfg.inverse else nu_true

    def zeromean_resvec(params, data):
        """sqrt(w / K) (slice mean of p - exact slice mean), [K]."""
        p_pred = make_w_fn(params)(data["x_zeromean"])[:, 2].reshape(n_zm, -1)
        return math.sqrt(w_zm / n_zm) * (p_pred @ data["w_zeromean"] - data["p_mean_exact"])

    def weak_residual(params, data):
        el = data["elements"]
        return mask_eq(ns_unsteady_residual(make_w_fn(params), el, data["basis_x"], data["basis_y"],
                                            data["basis_t"], var_form, nu_of(params)))

    def residual_fn(params, data):
        """Masked weak residual Res[e, i, m, k, r] (i = x-momentum,
        y-momentum, continuity): the GN residual block (sum(r^2) == loss)."""
        return weighted(weak_residual(params, data)) * data["elements"].mask[:, None]

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_3d, mesh, xq, wq, None, (nx_max, ny_max, nt_max), dtype=dtype, device=device))

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes not in the training
        basis (hierarchical indicator; see adaptive.element_indicator); the
        p_test_enrich mask is the training basis's and is not applied.
        Returns [E, 3, M+e, K+e, R+e] with the trained block zeroed."""
        bx_en, by_en, bt_en, elems_en, new = enriched(enrich)
        res = ns_unsteady_residual(make_w_fn(params), elems_en, bx_en, by_en, bt_en, var_form, nu_of(params))
        return weighted(res) * new[None, None]

    def loss_fn(params, data):
        """lossb_weight lossb + lossv (+ p_anchor_weight lossa without wall
        p, + lossz with the zero-mean gauge, + lossb_weight losss when
        inverse); aux {loss, lossb, lossv} and lossa, lossz, losss and nu
        where they apply: 0-d tensors of the problem's dtype."""
        w_fn = make_w_fn(params)
        el = data["elements"]
        lossv = variational_loss(weighted(weak_residual(params, data)), el.mask[:, None], el.n_test)
        wb_pred = w_fn(data["xb"])
        if not cfg.bc_pressure:
            wb_pred = wb_pred[:, :2]
        lossb = torch.mean((data["ub"] - wb_pred) ** 2)
        loss = wb_weight * lossb + lossv
        aux = {"lossb": lossb, "lossv": lossv}
        if not cfg.bc_pressure:
            lossa = torch.mean((w_fn(data["x_anchor"])[:, 2:3] - data["p_anchor"]) ** 2)
            loss = loss + wa * lossa
            aux["lossa"] = lossa
        if w_zm > 0.0:
            rz = zeromean_resvec(params, data)
            lossz = torch.sum(rz * rz)
            loss = loss + lossz
            aux["lossz"] = lossz
        if cfg.inverse:
            losss = torch.mean((data["us"] - w_fn(data["xs"])[:, :2]) ** 2)
            loss = loss + wb_weight * losss
            aux.update(losss=losss, nu=params["pde"]["nu"])
        aux["loss"] = loss
        return loss, aux

    # the quadratic terms beyond the weak residual and the boundary data, as
    # least-squares residuals: Gauss-Newton's identity sum(r^2) == loss
    reg_parts = []
    if not cfg.bc_pressure:
        reg_parts.append(lambda params, data: math.sqrt(wa / data["p_anchor"].numel()) * (
            make_w_fn(params)(data["x_anchor"])[:, 2:3] - data["p_anchor"]).reshape(-1))
    if cfg.inverse:
        reg_parts.append(lambda params, data: math.sqrt(wb_weight / data["us"].numel()) * (
            make_w_fn(params)(data["xs"])[:, :2] - data["us"]).reshape(-1))
    if w_zm > 0.0:
        reg_parts.append(zeromean_resvec)

    def reg_resvec_fn(params, data):
        return torch.cat([f(params, data) for f in reg_parts])

    def pde_init():
        return {"nu": nn.Parameter(torch.tensor(cfg.nu_init, dtype=dtype, device=device))}

    # dense test grid, 41 x 41 in space at 9 times (x fastest, t slowest);
    # trailing component axis (u, v, p)
    xt = np.linspace(*cfg.domain_x, 41)
    yt = np.linspace(*cfg.domain_y, 41)
    tt = np.linspace(cfg.t_start, cfg.t_final, 9)
    TT, YT, XT = np.meshgrid(tt, yt, xt, indexing="ij")
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1), TT.reshape(-1)], axis=-1)
    test_values = exact_stacked(test_points[:, 0], test_points[:, 1], test_points[:, 2], cfg.re)

    return Problem(
        name="taylorgreen",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init if cfg.inverse else None, dtype=dtype, device=device),
        exact=lambda x, y, t: exact_stacked(x, y, t, cfg.re),
        apply_override=(lambda params, X: make_w_fn(params)(X)) if cfg.hard_bc else None,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(tt), len(yt), len(xt)),
            "component_names": ("u", "v", "p"),
            "nu_true": nu_true,
            "nu_of": nu_of,
            **({"reg_resvec_fn": reg_resvec_fn} if reg_parts else {}),
        },
    )
