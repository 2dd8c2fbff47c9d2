"""3D Poisson: Delta u = f on [-1, 1]^3, hp-VPINN.

Counterpart of hpvpinns_tpu/problems/poisson3d.py (no reference analog: the
volumetric generalization of the tensor-product architecture).  The
manufactured solution is separable and steep in x, like the 2D benchmark:

    u = (0.1 sin(2 pi x) + tanh(5 x)) sin(2 pi y) sin(2 pi z),   f = Delta u

with 100 LHS boundary points per face and the loss 10 lossb + lossv.
"""

from __future__ import annotations

import numpy as np
import torch

from hpvpinns_tpu_torch.config import Poisson3DConfig
from hpvpinns_tpu_torch.geometry.mesh import TensorMesh3D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import poisson3d_residual, variational_loss
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_3d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_3d
from hpvpinns_tpu_torch.parallel.sharding import once, psum
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_composite_apply, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_3d, make_weighted_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_box

OMEGA = 2 * np.pi
R1 = 5.0

_FIELDS = {"taylor": taylor_fields_3d, "pallas": fused_fields_3d, "jvp": None}  # None: ops/fields.py on the ansatz


def _gx(x):
    return 0.1 * np.sin(OMEGA * x) + np.tanh(R1 * x)


def _gx2(x):
    return -0.1 * OMEGA**2 * np.sin(OMEGA * x) - (2 * R1**2) * np.tanh(R1 * x) / np.cosh(R1 * x) ** 2


def u_exact(x, y, z):
    return _gx(x) * np.sin(OMEGA * y) * np.sin(OMEGA * z)


def f_rhs(x, y, z):
    """f = Delta u (the sign convention of the 2D problem)."""
    return (
        _gx2(x) * np.sin(OMEGA * y) * np.sin(OMEGA * z)
        - 2 * OMEGA**2 * _gx(x) * np.sin(OMEGA * y) * np.sin(OMEGA * z)
    )


def boundary_points(cfg: Poisson3DConfig, rng: np.random.Generator, u_ex):
    """cfg.n_bound LHS points on each of the 6 faces with exact data; the
    draws from `rng` are the JAX package's, in the same order."""
    bounds = (cfg.domain_x, cfg.domain_y, cfg.domain_z)
    faces = []
    for fixed_axis, lo_hi in enumerate(bounds):
        free = [b for i, b in enumerate(bounds) if i != fixed_axis]
        for val in lo_hi:
            faces.append(np.insert(lhs_box(free, cfg.n_bound, rng), fixed_axis, val, axis=1))
    Xb = np.concatenate(faces)
    return Xb, u_ex(Xb[:, 0:1], Xb[:, 1:2], Xb[:, 2:3])


def default_lift(X):
    """Boundary interpolant of the benchmark solution: g = x tanh(5)
    sin(2 pi y) sin(2 pi z) matches u_exact on all six faces."""
    return X[:, 0:1] * np.tanh(R1) * torch.sin(OMEGA * X[:, 1:2]) * torch.sin(OMEGA * X[:, 2:3])


def default_envelope(X):
    """D = (1 - x^2)(1 - y^2)(1 - z^2): vanishes on the boundary of [-1,1]^3."""
    return (1.0 - X[:, 0:1] ** 2) * (1.0 - X[:, 1:2] ** 2) * (1.0 - X[:, 2:3] ** 2)


def build(
    cfg: Poisson3DConfig,
    rng: np.random.Generator | None = None,
    u_fn=None,
    f_fn=None,
    lift_fn=None,
    envelope_fn=None,
    *,
    device=None,
) -> Problem:
    """The Poisson-3D hp-VPINN problem on `device` (default: the card; pass
    device="cpu" for the CPU).  The positional arguments are the JAX
    package's: `rng` draws the boundary points, `u_fn`/`f_fn` override the
    exact solution and the forcing (numpy (x, y, z) -> value, f = Delta u),
    and `lift_fn`/`envelope_fn` (torch [P, 3] -> [P, 1]; cfg.hard_bc takes
    the defaults) switch on the hard-BC ansatz u = lift + envelope * N,
    whose fields come from the JVP engine.

    deriv_mode "taylor" takes the fields from the plain Taylor propagation,
    "pallas" from the fused CUDA kernels at n_dirs 3 (form 1: B1
    firsts-only; form 0: B1 with second derivatives and B2), which take
    float32 on a CUDA device (their plain versions run on the CPU), and
    "jvp" from the JVP engine."""
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"unknown deriv_mode {cfg.deriv_mode!r}")
    device = resolve_device(device)
    u_ex = u_fn or u_exact
    f_rh = f_fn or f_rhs
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    mesh = TensorMesh3D.uniform(
        *cfg.domain_x, cfg.n_elements_x, *cfg.domain_y, cfg.n_elements_y, *cfg.domain_z, cfg.n_elements_z,
    )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = cfg.n_test_x_per_elem if cfg.n_test_x_per_elem is not None else cfg.n_test_x
    nty = cfg.n_test_y_per_elem if cfg.n_test_y_per_elem is not None else cfg.n_test_y
    ntz = cfg.n_test_z_per_elem if cfg.n_test_z_per_elem is not None else cfg.n_test_z
    bx, by, bz = (make_weighted_basis(int(np.max(n)), xq, wq, dtype, device) for n in (ntx, nty, ntz))
    elems = build_elements_3d(mesh, xq, wq, f_rh, ntx, nty, ntz, dtype, device)

    Xb, ub = boundary_points(cfg, rng, u_ex)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "basis_z": bz,
        "xb": torch.as_tensor(Xb).to(device=device, dtype=dtype),
        "ub": torch.as_tensor(ub).to(device=device, dtype=dtype),
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
        """Masked weak residual Res[e, m, k, r]."""
        el = data["elements"]
        fields_fn = None if fields is None else (lambda x, y, z, **kw: fields(spec, params["net"], x, y, z, **kw))
        res = poisson3d_residual(make_u_fn(params), el, data["basis_x"], data["basis_y"], data["basis_z"],
                                 cfg.var_form, fields_fn)
        return res * el.mask

    def loss_fn(params, data, axis_name=None):
        """10 lossb + lossv; aux {loss, lossb, lossv}.  Under `axis_name`
        lossv is summed over the ranks and lossb counted once."""
        el = data["elements"]
        lossv = variational_loss(residual_fn(params, data), el.mask, el.n_test)
        lossb = torch.mean((data["ub"] - make_u_fn(params)(data["xb"])) ** 2)
        if axis_name is not None:
            lossv, lossb = psum(lossv, axis_name), once(lossb, axis_name)
        loss = wb * lossb + lossv
        return loss, {"loss": loss, "lossb": lossb, "lossv": lossv}

    # Test grid: 41^3 points (x the slowest).
    nt = 41
    axes = [np.linspace(*d, nt) for d in (cfg.domain_x, cfg.domain_y, cfg.domain_z)]
    XT, YT, ZT = np.meshgrid(*axes, indexing="ij")
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1), ZT.reshape(-1)], axis=-1)
    test_values = u_ex(test_points[:, 0:1], test_points[:, 1:2], test_points[:, 2:3])

    return Problem(
        name="poisson3d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype, device=device),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=test_points,
        test_values=test_values,
        extras={"mesh": mesh, "f_rhs": f_rh, "residual_fn": residual_fn, "test_grid_shape": (nt, nt, nt)},
    )
