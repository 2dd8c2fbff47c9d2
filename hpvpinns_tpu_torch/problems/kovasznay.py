"""Steady incompressible Navier-Stokes: Kovasznay flow.

Counterpart of hpvpinns_tpu/problems/kovasznay.py.  A system of coupled
PDEs: one 3-output ansatz w = (u, v, p) is trained against the stacked weak
residual of x/y-momentum and continuity (ops/assembly.py::ns_residual), its
derivative fields from the JVP engine (ops/fields.py::vector_fields_2d).

Exact solution (Kovasznay 1948), for nu = 1/Re:

    lam = Re/2 - sqrt(Re^2/4 + 4 pi^2)
    u   = 1 - e^{lam x} cos(2 pi y)
    v   = (lam / 2 pi) e^{lam x} sin(2 pi y)
    p   = (1 - e^{2 lam x}) / 2

Inverse mode: nu = params["pde"]["nu"] is trainable and identified from
interior (u, v) sensors.  The exact solution for the boundary, sensor and
test data is float64 numpy on the host; what runs in the loss (the hard-BC
lift and envelope) is torch operations on device tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import KovasznayConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import ns_residual, variational_loss
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_composite_apply, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_2d, build_enriched_2d, make_weighted_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_interval



def lam_of(re: float) -> float:
    return re / 2.0 - np.sqrt(re * re / 4.0 + 4.0 * np.pi**2)


def exact_fields(x, y, re: float):
    """(u, v, p) of the Kovasznay solution, float64 host math, each of the
    broadcast shape of x and y."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lam = lam_of(re)
    ex = np.exp(lam * x)
    u = 1.0 - ex * np.cos(2.0 * np.pi * y)
    v = (lam / (2.0 * np.pi)) * ex * np.sin(2.0 * np.pi * y)
    p = 0.5 * (1.0 - np.exp(2.0 * lam * x))
    return np.broadcast_arrays(u, v, p)


def exact_stacked(x, y, re: float):
    """Exact (u, v, p) stacked on a trailing component axis [..., 3]."""
    return np.stack(exact_fields(x, y, re), axis=-1)


def training_data(cfg: KovasznayConfig, rng: np.random.Generator):
    """LHS boundary points on the four edges with the exact (u, v, p), drawn
    from `rng` in the JAX package's order: (Xb [4n, 2], wb [4n, 3]); the
    caller drops p when cfg.bc_pressure is False."""
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    xs = lhs_interval(xl, xr, n, rng)
    xs2 = lhs_interval(xl, xr, n, rng)
    ys = lhs_interval(yl, yr, n, rng)
    ys2 = lhs_interval(yl, yr, n, rng)
    pts = np.concatenate([
        np.hstack([np.full_like(ys, xl), ys]),
        np.hstack([np.full_like(ys2, xr), ys2]),
        np.hstack([xs, np.full_like(xs, yl)]),
        np.hstack([xs2, np.full_like(xs2, yr)]),
    ])
    return pts, exact_stacked(pts[:, 0], pts[:, 1], cfg.re)


def sensor_data(cfg: KovasznayConfig, rng: np.random.Generator):
    """Interior (u, v) velocity sensors for the inverse problem."""
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    xs = lhs_interval(xl, xr, cfg.n_sensors, rng)
    ys = lhs_interval(yl, yr, cfg.n_sensors, rng)
    pts = np.hstack([xs, ys])
    u, v, _ = exact_fields(pts[:, 0], pts[:, 1], cfg.re)
    vals = np.stack([u, v], axis=-1)
    if cfg.sensor_noise > 0.0:
        vals = vals + cfg.sensor_noise * rng.standard_normal(vals.shape)
    return pts, vals


def exact_uv(re: float):
    """The exact velocity pair as torch maps (x, y) -> u and (x, y) -> v (the
    hard-BC lift's boundary traces, differentiated by the JVP engine)."""
    lam = lam_of(re)

    def u(x, y):
        return 1.0 - torch.exp(lam * x) * torch.cos(2.0 * math.pi * y)

    def v(x, y):
        return (lam / (2.0 * math.pi)) * torch.exp(lam * x) * torch.sin(2.0 * math.pi * y)

    return u, v


def coons_lift(g_fn, domain_x, domain_y):
    """The transfinite (Coons) interpolant of g's boundary trace, in torch
    operations: (x, y) -> value, equal to g on all four edges and built from
    its edge values only."""
    a, b = domain_x
    c, d = domain_y

    def lift(x, y):
        s = (x - a) / (b - a)
        t = (y - c) / (d - c)
        fa, fb = torch.full_like(x, a), torch.full_like(x, b)
        fc, fd = torch.full_like(y, c), torch.full_like(y, d)
        return (
            (1 - s) * g_fn(fa, y)
            + s * g_fn(fb, y)
            + (1 - t) * g_fn(x, fc)
            + t * g_fn(x, fd)
            - (1 - s) * (1 - t) * g_fn(fa, fc)
            - s * (1 - t) * g_fn(fb, fc)
            - (1 - s) * t * g_fn(fa, fd)
            - s * t * g_fn(fb, fd)
        )

    return lift


def build(cfg: KovasznayConfig, rng: np.random.Generator | None = None, *, device=None) -> Problem:
    """The Kovasznay problem on `device` (default: the card; pass
    device="cpu" for the CPU).  `rng` draws the boundary points and then the
    sensors.  The derivative fields come from the JVP engine whatever
    cfg.deriv_mode says, as in the JAX package."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    mesh = TensorMesh2D(axis_x=Interval1D.grid_or_uniform(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
                        axis_y=Interval1D.grid_or_uniform(cfg.grid_y, *cfg.domain_y, cfg.n_elements_y))
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = (np.asarray(cfg.n_test_x_per_elem) if cfg.n_test_x_per_elem is not None
           else np.full(mesh.axis_x.n_elem, cfg.n_test_x))
    nty = (np.asarray(cfg.n_test_y_per_elem) if cfg.n_test_y_per_elem is not None
           else np.full(mesh.axis_y.n_elem, cfg.n_test_y))
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype, device)
    by = make_weighted_basis(int(nty.max()), xq, wq, dtype, device)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, None, ntx, nty, dtype, device)

    def on_device(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    Xb, wb_full = training_data(cfg, rng)
    ub = wb_full if cfg.bc_pressure else wb_full[:, :2]
    data = {"elements": elems, "basis_x": bx, "basis_y": by, "xb": on_device(Xb), "ub": on_device(ub)}
    if not cfg.bc_pressure:
        # a one-point pressure anchor at the domain corner: the gauge when
        # only the velocity is prescribed on the boundary
        xa = np.array([[cfg.domain_x[0], cfg.domain_y[0]]])
        _, _, pa = exact_fields(xa[:, 0], xa[:, 1], cfg.re)
        data["x_anchor"] = on_device(xa)
        data["p_anchor"] = on_device(pa.reshape(1, 1))
    if cfg.inverse:
        Xs, us = sensor_data(cfg, rng)
        data["xs"], data["us"] = on_device(Xs), on_device(us)

    var_form, wb_weight, wa = cfg.var_form, cfg.lossb_weight, cfg.p_anchor_weight
    nu_true = 1.0 / cfg.re
    # per-equation residual weights [1, 3, 1, 1], in every residual view
    # (the loss and the GN residual vector alike)
    eqw = on_device(cfg.eq_weights)[None, :, None, None] if cfg.eq_weights is not None else None

    def weighted(res):
        return res if eqw is None else res * eqw

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)

    if cfg.hard_bc:
        if not cfg.bc_pressure:
            raise ValueError(
                "hard_bc requires bc_pressure=True: with (u, v) exact by "
                "construction the boundary p data is what fixes the gauge"
            )
        ue_fn, ve_fn = exact_uv(cfg.re)
        clift_u = coons_lift(ue_fn, cfg.domain_x, cfg.domain_y)
        clift_v = coons_lift(ve_fn, cfg.domain_x, cfg.domain_y)
        (xa_, xb_), (ya_, yb_) = cfg.domain_x, cfg.domain_y
        sx = ((xb_ - xa_) / 2.0) ** 2
        sy = ((yb_ - ya_) / 2.0) ** 2

        def lift(X):
            x, y = X[:, 0:1], X[:, 1:2]
            return torch.cat([clift_u(x, y), clift_v(x, y), torch.zeros_like(x)], dim=-1)

        def envelope(X):
            # the bubble (1 at the domain's center, 0 on its walls) for the
            # velocity pair; p is not enveloped
            x, y = X[:, 0:1], X[:, 1:2]
            bub = ((x - xa_) * (xb_ - x) / sx) * ((y - ya_) * (yb_ - y) / sy)
            return torch.cat([bub, bub, torch.ones_like(bub)], dim=-1)

        make_w_fn = make_composite_apply(spec, lift, envelope)
    else:

        def make_w_fn(params):
            return lambda X: mlp_apply(spec, params["net"], X)

    def nu_of(params):
        return params["pde"]["nu"] if cfg.inverse else nu_true

    def weak_residual(params, data):
        el = data["elements"]
        return ns_residual(make_w_fn(params), el, data["basis_x"], data["basis_y"], var_form, nu_of(params))

    def residual_fn(params, data):
        """Masked weak residual Res[e, i, k, r] (i = x-momentum, y-momentum,
        continuity): the GN residual block (sum(r^2) == loss)."""
        return weighted(weak_residual(params, data)) * data["elements"].mask[:, None]

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_2d, mesh, xq, wq, None, (int(ntx.max()), int(nty.max())), dtype=dtype, device=device))

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes not in the training
        basis (hierarchical a-posteriori indicator, the scalar families'
        construction; see adaptive.element_indicator).  Returns
        [E, 3, K+enrich, R+enrich] with the trained block zeroed."""
        bx_en, by_en, elems_en, new = enriched(enrich)
        res = ns_residual(make_w_fn(params), elems_en, bx_en, by_en, var_form, nu_of(params))
        return weighted(res) * new[None, None]

    def loss_fn(params, data):
        """lossb_weight lossb + lossv (+ p_anchor_weight lossa without
        boundary p, + lossb_weight losss when inverse); aux {loss, lossb,
        lossv} and lossa, losss and nu where they apply: 0-d tensors of the
        problem's dtype."""
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
            lossa = torch.sum((w_fn(data["x_anchor"])[:, 2:3] - data["p_anchor"]) ** 2)
            loss = loss + wa * lossa
            aux["lossa"] = lossa
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
        reg_parts.append(lambda params, data: math.sqrt(wa) * (
            make_w_fn(params)(data["x_anchor"])[:, 2:3] - data["p_anchor"]).reshape(-1))
    if cfg.inverse:
        reg_parts.append(lambda params, data: math.sqrt(wb_weight / data["us"].numel()) * (
            make_w_fn(params)(data["xs"])[:, :2] - data["us"]).reshape(-1))

    def reg_resvec_fn(params, data):
        return torch.cat([f(params, data) for f in reg_parts])

    def pde_init():
        return {"nu": nn.Parameter(torch.tensor(cfg.nu_init, dtype=dtype, device=device))}

    # dense test grid, 100 x 100, x fastest; trailing component axis (u, v, p)
    xt = np.linspace(*cfg.domain_x, 100)
    yt = np.linspace(*cfg.domain_y, 100)
    XT, YT = np.meshgrid(xt, yt)
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1)], axis=-1)
    test_values = exact_stacked(test_points[:, 0], test_points[:, 1], cfg.re)

    return Problem(
        name="kovasznay",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init if cfg.inverse else None, dtype=dtype, device=device),
        exact=lambda x, y: exact_stacked(x, y, cfg.re),
        apply_override=(lambda params, X: make_w_fn(params)(X)) if cfg.hard_bc else None,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(yt), len(xt)),
            "component_names": ("u", "v", "p"),
            "nu_true": nu_true,
            "nu_of": nu_of,
            **({"reg_resvec_fn": reg_resvec_fn} if reg_parts else {}),
        },
    )
