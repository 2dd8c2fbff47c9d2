"""2D space-time advection-diffusion with inverse coefficient identification.

Counterpart of hpvpinns_tpu/problems/advdiff2d.py:

    u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f   on [-1,1]^2 x [0,T]

the 2-space-dimension generalization of the reference's 1D inverse family
(AdvDiff.py:161-180 for the weak form), on the 3D tensor machinery with time
the slowest axis.  The problem is manufactured: u = sin(pi x) sin(pi y)
e^{-t} (zero on the four side walls) with the matching forcing at the true
coefficients; the truth enters through f, the t = 0 face and the sensor
readings.  eps, and with velocity_trainable the vector (vx, vy), are
trainable leaves of params["pde"].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import AdvDiff2DConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh3D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import advdiff2d_residual, variational_loss
from hpvpinns_tpu_torch.ops.derivatives import dir_deriv
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_3d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_3d
from hpvpinns_tpu_torch.problems.base import DTYPES, Problem, make_net_init, resolve_device
from hpvpinns_tpu_torch.problems.build import build_elements_3d, build_enriched_3d, make_weighted_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_box, lhs_interval

_FIELDS = {"taylor": taylor_fields_3d, "pallas": fused_fields_3d, "jvp": None}  # None: ops/fields.py on the net


def u_exact(x, y, t):
    """The manufactured solution (host numpy; broadcastable arrays)."""
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.exp(-t)


def make_forcing(cfg: AdvDiff2DConfig, eps_fn=None):
    """f = u_t + vx u_x + vy u_y - eps (u_xx + u_yy) for the manufactured u at
    the true coefficients (host float64, projected offline).  `eps_fn(x, y)`
    poses a true space-dependent diffusivity map instead of the scalar
    gamma / pi."""
    vx, vy = cfg.velocity
    eps_scalar = cfg.gamma / np.pi

    def f_fn(X, Y, T):
        sx, cx = np.sin(np.pi * X), np.cos(np.pi * X)
        sy, cy = np.sin(np.pi * Y), np.cos(np.pi * Y)
        eps = eps_fn(X, Y) if eps_fn is not None else eps_scalar
        return np.exp(-T) * (
            -sx * sy
            + vx * np.pi * cx * sy
            + vy * np.pi * sx * cy
            + 2.0 * eps * np.pi**2 * sx * sy
        )

    return f_fn


def training_data(cfg: AdvDiff2DConfig, rng: np.random.Generator):
    """Side-wall, initial-face and interior-sensor data, drawn from `rng` in
    the JAX package's order: four walls (LHS over the other space axis and
    t), the t = 0 face, then per station LHS times with exact readings (plus
    N(0, sensor_noise_std) noise from a generator seeded from `rng`)."""
    T = cfg.t_final
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    pts, vals = [], []
    for fixed_axis, lo_hi, free in ((0, (xl, xr), [(yl, yr), (0.0, T)]), (1, (yl, yr), [(xl, xr), (0.0, T)])):
        for val in lo_hi:
            p = np.insert(lhs_box(free, n, rng), fixed_axis, val, axis=1)
            pts.append(p)
            vals.append(u_exact(p[:, 0:1], p[:, 1:2], p[:, 2:3]))
    p0 = np.hstack([lhs_box([(xl, xr), (yl, yr)], n, rng), np.zeros((n, 1))])
    pts.append(p0)
    vals.append(u_exact(p0[:, 0:1], p0[:, 1:2], p0[:, 2:3]))
    noise_rng = np.random.default_rng(rng.integers(0, 2**31))
    for sx, sy in cfg.sensor_stations:
        ts = T * lhs_interval(0, 1, cfg.n_sensors_per_station, rng)
        p = np.hstack([np.full_like(ts, sx), np.full_like(ts, sy), ts])
        pts.append(p)
        reading = u_exact(p[:, 0:1], p[:, 1:2], p[:, 2:3])
        if cfg.sensor_noise_std > 0:
            reading = reading + noise_rng.normal(0.0, cfg.sensor_noise_std, reading.shape)
        vals.append(reading)
    return np.concatenate(pts), np.concatenate(vals)


def _mesh(cfg: AdvDiff2DConfig) -> TensorMesh3D:
    def axis(grid, lo, hi, n):
        return Interval1D(np.asarray(grid, dtype=np.float64)) if grid is not None else Interval1D.uniform(lo, hi, n)

    return TensorMesh3D(
        axis_x=axis(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
        axis_y=axis(cfg.grid_y, *cfg.domain_y, cfg.n_elements_y),
        axis_z=axis(cfg.grid_t, 0.0, cfg.t_final, cfg.n_elements_t),
    )


def build(
    cfg: AdvDiff2DConfig,
    rng: np.random.Generator | None = None,
    epsilon_fn=None,
    *,
    device=None,
) -> Problem:
    """The AdvDiff-2D problem on `device` (default: the card; pass
    device="cpu" for the CPU).  `rng` draws the training data;
    `epsilon_fn(x, y)` poses the manufactured problem at a true
    space-dependent diffusivity map, in generic array operations (numpy on
    the host for the forcing and eps_true, its domain mean; torch in the
    weak form of forward runs, with eps_x and eps_y by the JVP engine).

    deriv_mode "taylor" takes the fields from the plain Taylor propagation,
    "pallas" from the fused CUDA kernels at n_dirs 3 (form 0: B1 with second
    derivatives, uzz dropped, and B2 with a zero cotangent on it; form 1: B1
    firsts-only), which take float32 on a CUDA device (their plain versions
    run on the CPU), and "jvp" from the JVP engine on the network."""
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"deriv_mode must be one of {sorted(_FIELDS)}; got {cfg.deriv_mode!r}")
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    if epsilon_fn is not None:
        GX, GY = np.meshgrid(np.linspace(*cfg.domain_x, 257), np.linspace(*cfg.domain_y, 257), indexing="ij")
        eps_true = float(np.mean(np.asarray(epsilon_fn(GX, GY))))
    else:
        eps_true = cfg.gamma / np.pi
    mesh = _mesh(cfg)
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = cfg.n_test_x_per_elem if cfg.n_test_x_per_elem is not None else cfg.n_test_x
    nty = cfg.n_test_y_per_elem if cfg.n_test_y_per_elem is not None else cfg.n_test_y
    ntt = cfg.n_test_t_per_elem if cfg.n_test_t_per_elem is not None else cfg.n_test_t
    bx, by, bt = (make_weighted_basis(int(np.max(n)), xq, wq, dtype, device) for n in (ntx, nty, ntt))
    f_fn = make_forcing(cfg, eps_fn=epsilon_fn)
    elems = build_elements_3d(mesh, xq, wq, f_fn, ntx, nty, ntt, dtype, device)

    Xb, ub = training_data(cfg, rng)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "basis_t": bt,
        "xb": torch.as_tensor(Xb).to(device=device, dtype=dtype),
        "ub": torch.as_tensor(ub).to(device=device, dtype=dtype),
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form, wb, inverse = cfg.var_form, cfg.lossb_weight, cfg.inverse
    vx_true, vy_true = cfg.velocity
    fields = _FIELDS[cfg.deriv_mode]

    def leaf(value):
        return nn.Parameter(torch.tensor(value, dtype=dtype, device=device))

    def pde_init():
        if not inverse:
            return {}
        pde = {"epsilon": leaf(cfg.epsilon_init)}
        if cfg.velocity_trainable:
            pde["velocity"] = leaf(cfg.velocity_init)
        return pde

    def v_of(params):
        """(vx, vy): the trainable vector's entries or the true constants."""
        if inverse and cfg.velocity_trainable:
            v = params["pde"]["velocity"]
            return v[0], v[1]
        return vx_true, vy_true

    def eps_args(params, x, y):
        """(eps, eps_x, eps_y) for the weak form: the trainable scalar, or the
        true field with its derivatives on forward runs."""
        if epsilon_fn is not None and not inverse:
            ones = torch.ones_like(x)
            ex = dir_deriv(lambda q: epsilon_fn(q, y), x, ones)
            ey = dir_deriv(lambda q: epsilon_fn(x, q), y, ones)
            return epsilon_fn(x, y), ex, ey
        return (params["pde"]["epsilon"] if inverse else eps_true), 0.0, 0.0

    def u_of(params):
        return lambda X: mlp_apply(spec, params["net"], X)

    def residual_at(params, el, basis_x, basis_y, basis_t):
        fields_fn = None if fields is None else (lambda x, y, z, **kw: fields(spec, params["net"], x, y, z, **kw))
        vx, vy = v_of(params)
        e, ex, ey = eps_args(params, el.x, el.y)
        return advdiff2d_residual(u_of(params), el, basis_x, basis_y, basis_t, var_form,
                                  vx, vy, e, fields_fn=fields_fn, epsilon_x=ex, epsilon_y=ey)

    def residual_fn(params, data):
        """Masked weak residual Res[e, m, k, r]."""
        el = data["elements"]
        return residual_at(params, el, data["basis_x"], data["basis_y"], data["basis_t"]) * el.mask

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_3d, mesh, xq, wq, f_fn, tuple(int(np.max(n)) for n in (ntx, nty, ntt)), dtype=dtype,
        device=device))

    def enriched_residual_fn(params, enrich: int = 2):
        """Weak residual against the tensor test modes not in the training
        basis: hierarchical a-posteriori estimation on the 3D space-time
        family, on the training fields path.  Returns [E, M+e, K+e, R+e]
        with the trained block zeroed."""
        bx_en, by_en, bt_en, elems_en, new = enriched(enrich)
        return residual_at(params, elems_en, bx_en, by_en, bt_en) * new[None]

    def loss_fn(params, data):
        """lossb_weight lossb + lossv; aux {loss, lossb, lossv} and, when
        inverse, epsilon and (velocity_trainable) vx, vy and velocity = |V|:
        0-d tensors of the problem's dtype."""
        el = data["elements"]
        lossv = variational_loss(residual_fn(params, data), el.mask, el.n_test)
        lossb = torch.mean((data["ub"] - u_of(params)(data["xb"])) ** 2)
        loss = wb * lossb + lossv
        aux = {"loss": loss, "lossb": lossb, "lossv": lossv}
        if inverse:
            aux["epsilon"] = params["pde"]["epsilon"]
            if cfg.velocity_trainable:
                vx, vy = v_of(params)
                aux.update(vx=vx, vy=vy, velocity=torch.sqrt(vx * vx + vy * vy))
        return loss, aux

    # Test grid: 33 x 33 in space at 11 times.
    XT, YT, TT = np.meshgrid(np.linspace(*cfg.domain_x, 33), np.linspace(*cfg.domain_y, 33),
                             np.linspace(0.0, cfg.t_final, 11), indexing="ij")
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1), TT.reshape(-1)], axis=-1)
    test_values = u_exact(test_points[:, 0:1], test_points[:, 1:2], test_points[:, 2:3])

    return Problem(
        name="advdiff2d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype, device=device),
        exact=u_exact,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "epsilon_fn": epsilon_fn,
            "eps_true": eps_true,
            "eps_domain_mean": lambda params: params["pde"]["epsilon"].item() if inverse else eps_true,
            "velocity_true": float(np.hypot(vx_true, vy_true)),
            "v_of": v_of,
            "f_rhs": f_fn,
            "test_grid_shape": (33, 33, 11),
        },
    )
