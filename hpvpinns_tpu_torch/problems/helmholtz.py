"""2D Helmholtz benchmark: Delta u + k^2 u = f on [-1, 1]^2, hp-VPINN.

Counterpart of hpvpinns_tpu/problems/helmholtz.py.  The oscillatory,
indefinite extension of the Poisson family (ops/assembly.py::
helmholtz2d_residual: the Poisson weak forms plus the mass term), with the
benchmark

    u(x, y) = sin(k (x cos th + y sin th) + phase),   f = 0

an exact homogeneous plane wave driven through its Dirichlet trace alone.
`inverse=True` poses wavenumber identification: k^2 becomes the trainable
0-d leaf params["pde"]["k_sq"], informed by interior sensor readings; the
weak residual is affine in k^2, so closed_form_k_sq gives a network-free
estimate from a fitted network.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import Helmholtz2DConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import helmholtz2d_residual, variational_loss
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_2d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_composite_apply, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_2d, build_enriched_2d, make_weighted_basis
from hpvpinns_tpu_torch.problems.poisson2d import boundary_points  # the same layout: n_bound LHS points per edge
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_box

_FIELDS = {"taylor": taylor_fields_2d, "pallas": fused_fields_2d, "jvp": None}  # None: ops/fields.py on the ansatz


def _wave(cfg: Helmholtz2DConfig):
    th = np.deg2rad(cfg.wave_angle_deg)
    return float(cfg.k * np.cos(th)), float(cfg.k * np.sin(th)), float(cfg.wave_phase)


def make_exact(cfg: Helmholtz2DConfig):
    """The tilted plane wave (host numpy)."""
    kx, ky, phase = _wave(cfg)
    return lambda x, y: np.sin(kx * x + ky * y + phase)


def make_exact_torch(cfg: Helmholtz2DConfig):
    """The plane wave in torch operations (the hard-BC lift's boundary
    trace): the counterpart of make_exact_jnp."""
    kx, ky, phase = _wave(cfg)
    return lambda x, y: torch.sin(kx * x + ky * y + phase)


def zero_forcing(x, y):
    """f = 0: the plane wave solves the homogeneous Helmholtz equation."""
    return np.zeros(np.broadcast(x, y).shape)


def make_coons_lift(cfg: Helmholtz2DConfig, g):
    """The transfinite (Coons) interpolant of the boundary trace of g, a
    torch function (x, y) -> value: it matches g on all four edges and uses
    only boundary values."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y

    def lift(X):
        x, y = X[:, 0:1], X[:, 1:2]
        s = (x - xl) / (xr - xl)
        t = (y - yl) / (yu - yl)
        fx = lambda v: torch.full_like(x, v)  # noqa: E731
        fy = lambda v: torch.full_like(y, v)  # noqa: E731
        edges = (1 - s) * g(fx(xl), y) + s * g(fx(xr), y) + (1 - t) * g(x, fy(yl)) + t * g(x, fy(yu))
        corners = (
            (1 - s) * (1 - t) * g(fx(xl), fy(yl))
            + (1 - s) * t * g(fx(xl), fy(yu))
            + s * (1 - t) * g(fx(xr), fy(yl))
            + s * t * g(fx(xr), fy(yu))
        )
        return edges - corners

    return lift


def make_envelope(cfg: Helmholtz2DConfig):
    """D(x, y) = (1 - xi^2)(1 - eta^2), vanishing on the box's boundary."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y

    def envelope(X):
        xi = (2 * X[:, 0:1] - xl - xr) / (xr - xl)
        eta = (2 * X[:, 1:2] - yl - yu) / (yu - yl)
        return (1.0 - xi**2) * (1.0 - eta**2)

    return envelope


def _axis(grid, lo, hi, n):
    return Interval1D(np.asarray(grid, dtype=np.float64)) if grid is not None else Interval1D.uniform(lo, hi, n)


def build(
    cfg: Helmholtz2DConfig,
    rng: np.random.Generator | None = None,
    u_fn=None,
    f_fn=None,
    *,
    device=None,
) -> Problem:
    """The Helmholtz-2D problem on `device` (default: the card; pass
    device="cpu" for the CPU).  The positional arguments are the JAX
    package's: `rng` draws the boundary points and the sensors, `u_fn` /
    `f_fn` pose a manufactured variant (numpy-vectorized (x, y) -> value,
    f = Delta u + k^2 u; with hard_bc, u_fn is the lift's boundary trace
    and must also take torch tensors).  The default is the homogeneous
    plane wave.

    deriv_mode "taylor" takes the fields from the plain Taylor propagation,
    "pallas" from the fused CUDA kernels at n_dirs 2 (form 1: B1
    firsts-only; form 0: B1 with second derivatives and B2), which take
    float32 on a CUDA device (their plain versions run on the CPU), and
    "jvp" from the JVP engine on the ansatz, which hard_bc forces."""
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"deriv_mode must be one of {sorted(_FIELDS)}; got {cfg.deriv_mode!r}")
    device = resolve_device(device)
    u_ex = u_fn or make_exact(cfg)
    f_rh = f_fn or zero_forcing
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    k_sq_true = float(cfg.k) ** 2

    mesh = TensorMesh2D(axis_x=_axis(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
                        axis_y=_axis(cfg.grid_y, *cfg.domain_y, cfg.n_elements_y))
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = (np.asarray(cfg.n_test_x_per_elem) if cfg.n_test_x_per_elem is not None
           else np.full(mesh.axis_x.n_elem, cfg.n_test_x))
    nty = (np.asarray(cfg.n_test_y_per_elem) if cfg.n_test_y_per_elem is not None
           else np.full(mesh.axis_y.n_elem, cfg.n_test_y))
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype, device)
    by = make_weighted_basis(int(nty.max()), xq, wq, dtype, device)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, f_rh, ntx, nty, dtype, device)

    def on_device(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    Xb, ub = boundary_points(cfg, rng, u_ex)
    data = {"elements": elems, "basis_x": bx, "basis_y": by, "xb": on_device(Xb), "ub": on_device(ub)}
    if cfg.inverse:
        # interior sensors, drawn after the boundary points from the same rng
        Xs = lhs_box([cfg.domain_x, cfg.domain_y], cfg.n_sensors, rng)
        us = u_ex(Xs[:, 0:1], Xs[:, 1:2])
        if cfg.sensor_noise_std > 0:
            noise_rng = np.random.default_rng(rng.integers(0, 2**31))
            us = us + noise_rng.normal(0.0, cfg.sensor_noise_std, us.shape)
        data["xs"], data["us"] = on_device(Xs), on_device(us)

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form, wb, hard_bc = cfg.var_form, cfg.lossb_weight, cfg.hard_bc
    fields = _FIELDS["jvp" if hard_bc else cfg.deriv_mode]
    if hard_bc:
        composite = make_composite_apply(spec, make_coons_lift(cfg, u_fn or make_exact_torch(cfg)), make_envelope(cfg))

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def k_sq_of(params):
        return params["pde"]["k_sq"] if cfg.inverse else k_sq_true

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r]."""
        el = data["elements"]
        fields_fn = None if fields is None else (lambda x, y, **kw: fields(spec, params["net"], x, y, **kw))
        res = helmholtz2d_residual(make_u_fn(params), el, data["basis_x"], data["basis_y"], k_sq_of(params),
                                   var_form, fields_fn)
        return res * el.mask

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_2d, mesh, xq, wq, f_rh, (int(ntx.max()), int(nty.max())), dtype=dtype, device=device))

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes not in the training
        basis (hierarchical a-posteriori estimation; see
        adaptive.element_indicator).  Returns [E, K+enrich, R+enrich] with
        the trained block zeroed."""
        bx_en, by_en, elems_en, new = enriched(enrich)
        return helmholtz2d_residual(make_u_fn(params), elems_en, bx_en, by_en, k_sq_of(params), var_form) * new[None]

    def loss_fn(params, data):
        """lossb_weight (lossb + losss) + lossv, losss the sensor misfit of
        an inverse run; aux {loss, lossb, lossv} and, when inverse, losss
        and k_sq: 0-d tensors of the problem's dtype."""
        u_of = make_u_fn(params)
        el = data["elements"]
        lossb = torch.mean((data["ub"] - u_of(data["xb"])) ** 2)
        lossv = variational_loss(residual_fn(params, data), el.mask, el.n_test)
        loss = wb * lossb + lossv
        aux = {"lossb": lossb, "lossv": lossv}
        if cfg.inverse:
            losss = torch.mean((data["us"] - u_of(data["xs"])) ** 2)
            loss = loss + wb * losss
            aux.update(losss=losss, k_sq=params["pde"]["k_sq"])
        aux["loss"] = loss
        return loss, aux

    def reg_resvec_fn(params, data):
        """The sensor misfit as least-squares residuals: sum(r^2) equals its
        term of the loss, so Gauss-Newton's identity holds when inverse."""
        return np.sqrt(wb / data["us"].numel()) * (make_u_fn(params)(data["xs"]) - data["us"]).reshape(-1)

    def pde_init():
        return {"k_sq": nn.Parameter(torch.tensor(cfg.k_sq_init, dtype=dtype, device=device))}

    # Dense test grid at delta 0.01 (the Poisson-2D.py:418-426 convention).
    xt = np.arange(cfg.domain_x[0], cfg.domain_x[1] + 0.01, 0.01)
    yt = np.arange(cfg.domain_y[0], cfg.domain_y[1] + 0.01, 0.01)
    XT, YT = np.meshgrid(xt, yt)
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1)], axis=-1)
    test_values = u_ex(test_points[:, 0:1], test_points[:, 1:2])

    return Problem(
        name="helmholtz2d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init if cfg.inverse else None, dtype=dtype, device=device),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "f_rhs": f_rh,
            "k_sq_true": k_sq_true,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(yt), len(xt)),
            **({"reg_resvec_fn": reg_resvec_fn} if cfg.inverse else {}),
        },
    )


def closed_form_k_sq(problem: Problem, params) -> float:
    """Network-free wavenumber estimate from a fitted network: the weak
    residual is affine in k^2, Res(k^2) = A + k^2 B, so the least-squares
    minimizer over the masked test entries is k^2* = -<B, A> / <B, B>
    (two residual assemblies, in float64 on the host)."""
    if not problem.config.inverse:
        raise ValueError("closed_form_k_sq needs an inverse-mode problem (k_sq as a pde leaf)")
    data = problem.data
    res_fn = problem.extras["residual_fn"]
    ref = params["pde"]["k_sq"]

    def at(value):
        p = dict(params, pde=dict(params["pde"], k_sq=torch.tensor(value, dtype=ref.dtype, device=ref.device)))
        return res_fn(p, data).detach().cpu().numpy().astype(np.float64)

    A = at(0.0)
    B = at(1.0) - A
    return -float((B * A).sum()) / float((B * B).sum())
