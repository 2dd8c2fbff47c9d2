"""1D Poisson benchmark: -u'' = f on [-1, 1], hp-VPINN.

Counterpart of hpvpinns_tpu/problems/poisson1d.py.  Problem of record
(main/Poisson-1D/hp-VPINN-Poisson-1D.py):
    u(x) = 0.1 sin(8 pi x) + tanh(80 x)              (:248-253)
    f(x) = -u''(x)                                    (:255-257)
    boundary data: u(+-1) only                        (:298-299)
    loss = lossb_weight * mean((u_b - u_hat_b)^2) + sum_e mean_n Res^2
                                                      (:98-100)
"""

from __future__ import annotations

import numpy as np
import torch

from hpvpinns_tpu_torch.config import Poisson1DConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import poisson1d_residual, variational_loss
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_1d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_1d
from hpvpinns_tpu_torch.parallel.sharding import once, psum
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_composite_apply, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_1d, make_weighted_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi

OMEGA = 8 * np.pi
AMP = 1.0
R1 = 80.0

_FIELDS = {"taylor": taylor_fields_1d, "pallas": fused_fields_1d, "jvp": None}  # None: ops/fields.py on the ansatz


def u_exact(x):
    """Poisson-1D.py:251-253."""
    return AMP * (0.1 * np.sin(OMEGA * x) + np.tanh(R1 * x))


def f_rhs(x):
    """f = -u'' (Poisson-1D.py:255-257)."""
    g = -0.1 * OMEGA**2 * np.sin(OMEGA * x) - (2 * R1**2) * np.tanh(R1 * x) / np.cosh(R1 * x) ** 2
    return -AMP * g


def make_mesh(cfg: Poisson1DConfig) -> Interval1D:
    if cfg.grid is not None:
        return Interval1D(grid=np.asarray(cfg.grid, dtype=np.float64))
    return Interval1D.uniform(cfg.domain[0], cfg.domain[1], cfg.n_elements)


def default_lift_1d(domain, u_ex):
    """Linear interpolant of the Dirichlet data over the domain."""
    a, b = domain
    ua, ub = float(u_ex(np.array(a))), float(u_ex(np.array(b)))

    def lift(X):
        return ua + (ub - ua) * (X - a) / (b - a)

    return lift


def default_envelope_1d(domain):
    """D(x) = (x - a)(b - x), vanishing at both endpoints."""
    a, b = domain

    def envelope(X):
        return (X - a) * (b - X)

    return envelope


def _check_supported(cfg: Poisson1DConfig) -> None:
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"deriv_mode must be one of {sorted(_FIELDS)}; got {cfg.deriv_mode!r}")


def build(cfg: Poisson1DConfig, u_fn=None, f_fn=None, hard_bc: bool | None = None, *, device=None) -> Problem:
    """The Poisson-1D hp-VPINN problem on `device` (default: the card,
    torch.device("cuda"); pass device="cpu" for the CPU).  The positional
    arguments are the JAX package's: `u_fn`/`f_fn` override the exact
    solution and the forcing (numpy vectorized, f = -u''), and `hard_bc`
    (default cfg.hard_bc) switches on the lifted ansatz u = g + D N with
    the linear lift of the boundary data and D = (x - a)(b - x).

    deriv_mode "taylor" takes (u, u_x, u_xx) from the plain Taylor
    propagation; "jvp" from the JVP engine on the ansatz (ops/fields.py;
    forced by hard_bc, whose ansatz is not a bare MLP); "pallas" from the
    fused CUDA kernels (B1 forward, B2 backward, ops/fused_fields.py), which
    need float32 on a CUDA device; on the CPU their plain versions run.  The
    offline arrays are assembled in float64 on the host, then cast to
    cfg.dtype.
    """
    _check_supported(cfg)
    hard_bc = cfg.hard_bc if hard_bc is None else hard_bc
    device = resolve_device(device)
    u_ex = u_fn or u_exact
    f_rh = f_fn or f_rhs
    dtype = DTYPES[cfg.dtype]
    mesh = make_mesh(cfg)
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    n_per_elem = (
        np.asarray(cfg.n_test_per_elem)
        if cfg.n_test_per_elem is not None
        else np.full(mesh.n_elem, cfg.n_test)
    )
    basis = make_weighted_basis(int(n_per_elem.max()), xq, wq, dtype, device)
    elems = build_elements_1d(mesh, xq, wq, f_rh, n_per_elem, dtype, device)

    # Boundary training data: the domain endpoints (Poisson-1D.py:298-299).
    xb = np.asarray(cfg.domain, dtype=np.float64)[:, None]
    data = {
        "elements": elems,
        "basis": basis,
        "xb": torch.as_tensor(xb).to(device=device, dtype=dtype),
        "ub": torch.as_tensor(u_ex(xb)).to(device=device, dtype=dtype),
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    fields = _FIELDS["jvp" if hard_bc else cfg.deriv_mode]
    if hard_bc:
        composite = make_composite_apply(spec, default_lift_1d(cfg.domain, u_ex), default_envelope_1d(cfg.domain))

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def residual_fn(params, data):
        """Masked weak residual Res[e, n]."""
        el = data["elements"]
        fields_fn = None if fields is None else (lambda x: fields(spec, params["net"], x))
        return poisson1d_residual(make_u_fn(params), el, data["basis"], cfg.var_form, fields_fn) * el.mask

    def loss_fn(params, data, axis_name=None):
        """lossb_weight lossb + lossv (Poisson-1D.py:98-100).  Under
        `axis_name` (an element Axis, parallel/sharding.py) lossv is summed
        over the ranks and lossb counted once."""
        el = data["elements"]
        lossv = variational_loss(residual_fn(params, data), el.mask, el.n_test)
        lossb = torch.mean((data["ub"] - make_u_fn(params)(data["xb"])) ** 2)
        if axis_name is not None:
            lossv, lossb = psum(lossv, axis_name), once(lossb, axis_name)
        loss = cfg.lossb_weight * lossb + lossv
        return loss, {"loss": loss, "lossb": lossb, "lossv": lossv}

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 4):
        """Weak residual against the next `enrich` test modes beyond the
        training basis (hierarchical a-posteriori estimation): the trained
        residual is near-orthogonal to the training modes, so under-resolution
        shows up in the first untrained modes.  Returns [E, enrich].  The
        fields come from the JVP engine, as the JAX package's come from
        generic AD."""
        n_max = int(n_per_elem.max())
        key = n_max + enrich
        if key not in _enriched_cache:
            basis_en = make_weighted_basis(key, xq, wq, dtype, device)
            elems_en = build_elements_1d(mesh, xq, wq, f_rh, np.full(mesh.n_elem, key), dtype, device)
            _enriched_cache[key] = (basis_en, elems_en)
        basis_en, elems_en = _enriched_cache[key]
        return poisson1d_residual(make_u_fn(params), elems_en, basis_en, cfg.var_form)[:, n_max:]

    xt = np.arange(-1.0, 1.0 + 0.001, 0.001)[:, None]  # Poisson-1D.py:315-316
    return Problem(
        name="poisson1d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype, device=device),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=xt,
        test_values=u_ex(xt),
        extras={
            "mesh": mesh,
            "f_rhs": f_rh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
        },
    )
