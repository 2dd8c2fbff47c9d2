"""2D Poisson benchmark: Delta u = f on [-1, 1]^2, hp-VPINN.

Counterpart of hpvpinns_tpu/problems/poisson2d.py.  Problem of record
(main/Poisson-2D/hp-VPINN-Poisson-2D.py):
    u(x, y) = (0.1 sin(2 pi x) + tanh(10 x)) sin(2 pi y)   (:300-305)
    f = Delta u                                            (:307-310)
    boundary data: 80 LHS points per edge                  (:313-347)
    VPINN loss = 10 lossb + lossv                          (:126-129)
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from hpvpinns_tpu_torch.config import Poisson2DConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import poisson2d_residual, variational_loss
from hpvpinns_tpu_torch.ops.fields import scalar_fields_2d
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_2d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_composite_apply, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_2d, build_enriched_2d, make_weighted_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_box, lhs_interval

OMEGA_X = 2 * np.pi
OMEGA_Y = 2 * np.pi
R1 = 10.0

_FIELDS = {"taylor": taylor_fields_2d, "pallas": fused_fields_2d, "jvp": None}  # None: ops/fields.py on the ansatz


def u_exact(x, y):
    """Poisson-2D.py:303-305."""
    return (0.1 * np.sin(OMEGA_X * x) + np.tanh(R1 * x)) * np.sin(OMEGA_Y * y)


def f_rhs(x, y):
    """f = Delta u (Poisson-2D.py:307-310)."""
    return (
        -0.1 * OMEGA_X**2 * np.sin(OMEGA_X * x)
        - (2 * R1**2) * np.tanh(R1 * x) / np.cosh(R1 * x) ** 2
    ) * np.sin(OMEGA_Y * y) + (0.1 * np.sin(OMEGA_X * x) + np.tanh(R1 * x)) * (
        -(OMEGA_Y**2) * np.sin(OMEGA_Y * y)
    )


def boundary_points(cfg: Poisson2DConfig, rng: np.random.Generator, u_ex=u_exact):
    """80 LHS points per edge with exact data (Poisson-2D.py:313-347); the
    draws from `rng` are the JAX package's, in the same order."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    edges = []
    for i in range(2):  # up, lo: x varies
        x = lhs_interval(xl, xr, n, rng)
        edges.append(np.hstack([x, np.full_like(x, yu if i == 0 else yl)]))
    for i in range(2):  # ri, le: y varies
        y = lhs_interval(yl, yu, n, rng)
        edges.append(np.hstack([np.full_like(y, xr if i == 0 else xl), y]))
    Xb = np.concatenate(edges)
    ub = u_ex(Xb[:, 0:1], Xb[:, 1:2])
    return Xb, ub


def default_lift(X):
    """Boundary interpolant g for the benchmark solution: g = x tanh(10)
    sin(2 pi y) matches u_exact on all four edges (u vanishes at y = +-1)."""
    return X[:, 0:1] * np.tanh(R1) * torch.sin(OMEGA_Y * X[:, 1:2])


def default_envelope(X):
    """D(x, y) = (1 - x^2)(1 - y^2): vanishes on the boundary of [-1,1]^2."""
    return (1.0 - X[:, 0:1] ** 2) * (1.0 - X[:, 1:2] ** 2)


def _check_supported(cfg: Poisson2DConfig) -> None:
    if cfg.scheme not in ("VPINNs", "PINNs"):
        raise ValueError(f"scheme must be 'VPINNs' or 'PINNs'; got {cfg.scheme!r}")
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"deriv_mode must be one of {sorted(_FIELDS)}; got {cfg.deriv_mode!r}")
    if cfg.var_form not in (0, 1, 2, "2c"):
        raise ValueError(f"Poisson-2D var_form must be 0, 1, 2 or '2c'; got {cfg.var_form!r}")
    on_ref_elem = (cfg.n_elements_x == 1 and cfg.n_elements_y == 1
                   and cfg.domain_x == (-1.0, 1.0) and cfg.domain_y == (-1.0, 1.0))
    if cfg.scheme == "VPINNs" and cfg.var_form == 2 and not on_ref_elem:
        # The verbatim reference form 2 (Poisson-2D.py:108-115) lacks the
        # 1/jac^2 scalings and the boundary flux.
        warnings.warn(
            "Poisson-2D var_form=2 replicates the reference's inconsistent "
            "twice-integrated form (Poisson-2D.py:108-115): it is only a "
            "valid weak form on a single [-1,1]^2 element. Use var_form "
            "'2c' for the mathematically correct twice-IBP form, or 0/1.",
            stacklevel=3,
        )


def build(
    cfg: Poisson2DConfig,
    rng: np.random.Generator | None = None,
    u_fn=None,
    f_fn=None,
    lift_fn=None,
    envelope_fn=None,
    *,
    device=None,
) -> Problem:
    """The Poisson-2D hp-VPINN problem on `device` (default: the card,
    torch.device("cuda"); pass device="cpu" for the CPU).  The positional
    arguments are the JAX package's: `rng` draws the boundary points,
    `u_fn`/`f_fn` override the exact solution and the forcing (numpy
    vectorized (x, y) -> value, f = Delta u), and `lift_fn`/`envelope_fn`
    (torch functions [P, 2] -> [P, 1]; cfg.hard_bc takes default_lift and
    default_envelope) switch on the hard-BC ansatz u = lift + envelope * N,
    exact on the boundary for any parameters.

    deriv_mode "taylor" takes the derivative fields from the plain Taylor
    propagation (ops/taylor.py); "jvp" from the JVP engine on the ansatz
    (ops/fields.py; forced by the hard-BC ansatz, which is not a bare MLP);
    "pallas" (the JAX package's name, kept so a JAX config maps one to one)
    from the fused CUDA kernels (ops/fused_fields.py: B1 forward, and B2
    backward for the second-derivative forms 0/2/"2c"), which need a CUDA
    device and float32; on the CPU their plain versions run.  The PINN
    scheme's strong-form loss always takes the JVP engine, as the JAX
    package's does.  The offline arrays are assembled in float64 on the
    host, then cast to cfg.dtype.
    """
    _check_supported(cfg)
    device = resolve_device(device)
    u_ex = u_fn or u_exact
    f_rh = f_fn or f_rhs
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    if cfg.grid_x is not None or cfg.grid_y is not None:
        ax = (
            Interval1D(np.asarray(cfg.grid_x, dtype=np.float64))
            if cfg.grid_x is not None
            else Interval1D.uniform(*cfg.domain_x, cfg.n_elements_x)
        )
        ay = (
            Interval1D(np.asarray(cfg.grid_y, dtype=np.float64))
            if cfg.grid_y is not None
            else Interval1D.uniform(*cfg.domain_y, cfg.n_elements_y)
        )
        mesh = TensorMesh2D(axis_x=ax, axis_y=ay)
    else:
        mesh = TensorMesh2D.uniform(*cfg.domain_x, cfg.n_elements_x, *cfg.domain_y, cfg.n_elements_y)
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)

    ntx = (
        np.asarray(cfg.n_test_x_per_elem)
        if cfg.n_test_x_per_elem is not None
        else np.full(mesh.axis_x.n_elem, cfg.n_test_x)
    )
    nty = (
        np.asarray(cfg.n_test_y_per_elem)
        if cfg.n_test_y_per_elem is not None
        else np.full(mesh.axis_y.n_elem, cfg.n_test_y)
    )
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype, device)
    by = make_weighted_basis(int(nty.max()), xq, wq, dtype, device)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, f_rh, ntx, nty, dtype, device)

    Xb, ub = boundary_points(cfg, rng, u_ex)
    # PINN-mode residual collocation points (Poisson-2D.py:350-356), drawn
    # after the boundary points from the same rng.
    Xf = lhs_box([cfg.domain_x, cfg.domain_y], cfg.n_residual, rng)
    ff = f_rh(Xf[:, 0:1], Xf[:, 1:2])
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        **{k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in (("xb", Xb), ("ub", ub), ("xf", Xf), ("ff", ff))},
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    wb = cfg.lossb_weight
    hard_bc = cfg.hard_bc or lift_fn is not None or envelope_fn is not None
    fields = _FIELDS["jvp" if hard_bc else cfg.deriv_mode]
    if hard_bc:
        composite = make_composite_apply(spec, lift_fn or default_lift, envelope_fn or default_envelope)

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r]."""
        el = data["elements"]
        fields_fn = None if fields is None else (lambda x, y, **kw: fields(spec, params["net"], x, y, **kw))
        res = poisson2d_residual(make_u_fn(params), el, data["basis_x"], data["basis_y"], cfg.var_form, fields_fn)
        return res * el.mask

    def loss_fn(params, data):
        """10 lossb + lossv (Poisson-2D.py:126-129), or under the PINN scheme
        10 lossb + lossp, lossp the mean squared strong residual at the
        collocation points (Poisson-2D.py:124,128-129)."""
        u_fn = make_u_fn(params)
        lossb = torch.mean((data["ub"] - u_fn(data["xb"])) ** 2)
        aux = {"lossb": lossb}
        if cfg.scheme == "VPINNs":
            el = data["elements"]
            lossv = variational_loss(residual_fn(params, data), el.mask, el.n_test)
            loss = wb * lossb + lossv
            aux["lossv"] = lossv
        else:
            flds = scalar_fields_2d(u_fn, data["xf"][:, 0:1], data["xf"][:, 1:2], second_y=True)
            lossp = torch.mean((flds["uxx"] + flds["uyy"] - data["ff"]) ** 2)
            loss = wb * lossb + lossp
            aux["lossp"] = lossp
        aux["loss"] = loss
        return loss, aux

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_2d, mesh, xq, wq, f_rh, (int(ntx.max()), int(nty.max())), dtype=dtype, device=device))

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes not in the training
        basis (either index beyond it): hierarchical a-posteriori estimation,
        the 2D twin of poisson1d's (see adaptive.element_indicator).
        Returns [E, K+enrich, R+enrich] with the trained block zeroed."""
        bx_en, by_en, elems_en, new = enriched(enrich)
        return poisson2d_residual(make_u_fn(params), elems_en, bx_en, by_en, cfg.var_form) * new[None]

    # Dense test grid, 201 x 201 at delta 0.01 (Poisson-2D.py:418-426).
    xt = np.arange(cfg.domain_x[0], cfg.domain_x[1] + 0.01, 0.01)
    yt = np.arange(cfg.domain_y[0], cfg.domain_y[1] + 0.01, 0.01)
    XT, YT = np.meshgrid(xt, yt)
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1)], axis=-1)
    test_values = u_ex(test_points[:, 0:1], test_points[:, 1:2])

    return Problem(
        name="poisson2d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype, device=device),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "f_rhs": f_rh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(yt), len(xt)),
        },
    )
