"""Space-time advection-diffusion with inverse coefficient identification.

Counterpart of hpvpinns_tpu/problems/advdiff.py (main/AdvDiff-Identification):

    u_t + V u_x = eps u_xx   on (x, t) in [-1, 1] x [0, T]
    u(x, 0) = -sin(pi x),  u(+-1, t) = 0                   (AdvDiff.py:351-353)
    true eps = gamma / pi                                   (AdvDiff.py:41-42)

The diffusion coefficient eps is a trainable leaf of params["pde"]
initialised at 1.0 (AdvDiff.py:63), trained jointly with the network by the
same optimizer; 15 interior sensor readings (3 stations x 5 LHS times,
AdvDiff.py:464-483) make it identifiable.  The exact solution is an
800-term Fourier series (AdvDiff.py:416-445).  Beyond the reference, as in
the JAX package: eps(x) as a quadratic or a small network, a trainable
velocity field, manufactured solutions, the hard-BC ansatz, the outflow-layer
input feature and time slabs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import AdvDiffConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import advdiff_residual, variational_loss
from hpvpinns_tpu_torch.ops.derivatives import dir_deriv
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_2d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d
from hpvpinns_tpu_torch.parallel.sharding import once, points_of, psum
from hpvpinns_tpu_torch.problems.base import (
    DTYPES,
    Problem,
    make_composite_apply,
    make_feature_apply,
    make_net_init,
    resolve_device,
)
from hpvpinns_tpu_torch.problems.build import build_elements_2d, build_enriched_2d, make_weighted_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.utils.sampling import lhs_interval

_FIELDS = {"taylor": taylor_fields_2d, "pallas": fused_fields_2d, "jvp": None}  # None: ops/fields.py on the ansatz
_SERIES_ROWS = 4096  # u_exact evaluates the series this many points at a time


def u_initial(x):
    """AdvDiff.py:351-353."""
    return -np.sin(np.pi * x)


def _series(xc, tc, D, V, trunc):
    """The series of AdvDiff.py:416-445 at column arrays xc, tc [N, 1]."""
    p = np.arange(0, trunc + 1.0)[None, :]
    c0 = 16 * np.pi**2 * D**3 * V * np.exp(V / D / 2 * (xc - V * tc / 2))
    c1_n = (-1.0) ** p * 2 * p * np.sin(p * np.pi * xc) * np.exp(-D * p**2 * np.pi**2 * tc)
    c1_d = V**4 + 8 * (V * np.pi * D) ** 2 * (p**2 + 1) + 16 * (np.pi * D) ** 4 * (p**2 - 1) ** 2
    c1 = np.sinh(V / D / 2) * np.sum(c1_n / c1_d, axis=-1, keepdims=True)
    c2_n = (
        (-1.0) ** p
        * (2 * p + 1)
        * np.cos((p + 0.5) * np.pi * xc)
        * np.exp(-D * (2 * p + 1) ** 2 * np.pi**2 * tc / 4)
    )
    c2_d = V**4 + (V * np.pi * D) ** 2 * (8 * p**2 + 8 * p + 10) + (np.pi * D) ** 4 * (
        4 * p**2 + 4 * p - 3
    ) ** 2
    c2 = np.cosh(V / D / 2) * np.sum(c2_n / c2_d, axis=-1, keepdims=True)
    return c0 * (c1 + c2)


def u_exact(x, t, epsilon, velocity, trunc=800):
    """Analytic Fourier-series solution (AdvDiff.py:416-445), vectorized.

    x, t: broadcastable column arrays [N, 1]; at t == 0 returns u_initial
    exactly, as the reference does (AdvDiff.py:442-443).  The series is
    summed _SERIES_ROWS points at a time (each row's sum is the same as in
    one pass), so memory stays at [_SERIES_ROWS, trunc + 1] arrays."""
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    x, t = np.broadcast_arrays(x, t)
    xc, tc = x.reshape(-1, 1), t.reshape(-1, 1)
    c = np.concatenate(
        [_series(xc[i : i + _SERIES_ROWS], tc[i : i + _SERIES_ROWS], epsilon, velocity, trunc)
         for i in range(0, xc.shape[0], _SERIES_ROWS)] or [np.zeros((0, 1))]
    ).reshape(x.shape)
    return np.where(t == 0, u_initial(x), c)


def default_lift(X):
    """Space-time lift g(x, t) = -sin(pi x): exact on both data boundaries
    (u(+-1, t) = 0 and u(x, 0) = -sin(pi x), AdvDiff.py:351-353)."""
    return -torch.sin(np.pi * X[:, 0:1])


def make_default_envelope(cfg: AdvDiffConfig, rate: float = 4.0):
    """D(x, t) = (x - a)(b - x)/((b-a)/2)^2 * (1 - exp(-rate t / T)): it
    vanishes on x = a, b and on t = 0, so the hard-BC ansatz u = g + D N
    satisfies the BC and the IC exactly for any parameters.  The saturating
    time factor is the JAX package's measured choice; even so the hard-BC
    ansatz is seed-unreliable for f32 identification there, and soft BC is
    its recommendation for inverse runs."""
    a, b = cfg.domain_x
    scale = ((b - a) / 2.0) ** 2

    def envelope(X):
        tfac = 1.0 - torch.exp(-rate * X[:, 1:2] / cfg.t_final)
        return (X[:, 0:1] - a) * (b - X[:, 0:1]) / scale * tfac

    return envelope


def training_data(cfg: AdvDiffConfig, rng: np.random.Generator, u_data_fn=None, ic_fn=None):
    """Boundary + initial + interior-sensor data (AdvDiff.py:357-384,464-483),
    with the JAX package's draws from `rng` in the same order.

    `u_data_fn(x, t) -> u` (numpy, column arrays) overrides the data source
    everywhere (boundary, initial edge and sensor readings) for manufactured
    problems; `ic_fn(x) -> u` overrides the initial edge only, placed at
    t = cfg.t_start (a previous time slab's state); without it a
    t_start > 0 slab takes the exact series at t_start.  The sensor noise
    has its own generator, spawned from `rng` whether or not there is noise,
    so the sensor locations are the same with and without it."""
    T0, T, (xl, xr) = cfg.t_start, cfg.t_final, cfg.domain_x
    n = cfg.n_bound
    eps_true = cfg.gamma / np.pi

    t_up = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    t_lo = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    x_in = lhs_interval(xl, xr, n, rng)
    t_in = np.full_like(x_in, T0)
    pts = [
        np.hstack([np.full_like(t_up, xr), t_up]),
        np.hstack([np.full_like(t_lo, xl), t_lo]),
        np.hstack([x_in, t_in]),
    ]
    if ic_fn is not None:
        u0 = np.asarray(ic_fn(x_in)).reshape(n, 1)
    elif u_data_fn is not None:
        u0 = u_data_fn(x_in, t_in)
    elif T0 == 0.0:
        u0 = u_initial(x_in)
    else:
        u0 = u_exact(x_in, t_in, eps_true, cfg.velocity, cfg.fourier_terms)
    if u_data_fn is None:
        vals = [np.zeros((n, 1)), np.zeros((n, 1)), u0]
    else:
        vals = [u_data_fn(np.full_like(t_up, xr), t_up), u_data_fn(np.full_like(t_lo, xl), t_lo), u0]

    noise_rng = np.random.default_rng(rng.integers(0, 2**31))
    for station in cfg.sensor_stations:
        ts = T0 + (T - T0) * lhs_interval(0, 1, cfg.n_sensors_per_station, rng)
        xs = np.full_like(ts, station)
        pts.append(np.hstack([xs, ts]))
        if u_data_fn is None:
            reading = u_exact(xs, ts, eps_true, cfg.velocity, cfg.fourier_terms)
        else:
            reading = u_data_fn(xs, ts)
        if cfg.sensor_noise_std > 0:
            reading = reading + noise_rng.normal(0.0, cfg.sensor_noise_std, reading.shape)
        vals.append(reading)
    return np.concatenate(pts), np.concatenate(vals)


def make_manufactured(cfg: AdvDiffConfig, velocity_fn, epsilon=None, profile: str = "sin"):
    """Manufactured pair (u_fn, f_fn) for the forced equation
    u_t + V(x) u_x - eps u_xx = f(x, t), homogeneous at x = +-1.

    `velocity_fn` (and a callable `epsilon`, a true field eps(x)) must use
    generic operators (e.g. ``lambda x: 1.0 + 0.3 * x``): they are called on
    numpy arrays here and on tensors inside the weak form.  `epsilon`
    defaults to gamma/pi.  `profile` "sin": u = sin(pi x) e^{-t} (u_xx
    vanishes at x = 0); "cos": u = cos(pi x / 2) e^{-t} (u_xx nonzero in the
    whole interior, the observable choice for a coefficient field)."""
    if epsilon is None:
        eps_fn = lambda x: cfg.gamma / np.pi  # noqa: E731
    elif callable(epsilon):
        eps_fn = epsilon
    else:
        eps_fn = lambda x: epsilon  # noqa: E731

    if profile == "sin":

        def u_fn(x, t):
            return np.sin(np.pi * x) * np.exp(-t)

        def f_fn(X, T):
            return np.exp(-T) * (
                -np.sin(np.pi * X)
                + velocity_fn(X) * np.pi * np.cos(np.pi * X)
                + eps_fn(X) * np.pi**2 * np.sin(np.pi * X)
            )

    elif profile == "cos":
        h = np.pi / 2.0

        def u_fn(x, t):
            return np.cos(h * x) * np.exp(-t)

        def f_fn(X, T):
            return np.exp(-T) * (
                -np.cos(h * X)
                - velocity_fn(X) * h * np.sin(h * X)
                + eps_fn(X) * h**2 * np.cos(h * X)
            )

    else:
        raise ValueError(f"profile must be 'sin' or 'cos'; got {profile!r}")

    return u_fn, f_fn


def _domain_mean(fn, a: float, b: float) -> float:
    xs = np.linspace(a, b, 4097)
    return float(np.trapezoid(np.asarray(fn(xs)), xs) / (b - a))


def _mesh(cfg: AdvDiffConfig) -> TensorMesh2D:
    if cfg.grid_x is None and cfg.grid_t is None:
        return TensorMesh2D.uniform(*cfg.domain_x, cfg.n_elements_x, cfg.t_start, cfg.t_final, cfg.n_elements_t)
    ax = (Interval1D(np.asarray(cfg.grid_x, dtype=np.float64)) if cfg.grid_x is not None
          else Interval1D.uniform(*cfg.domain_x, cfg.n_elements_x))
    at = (Interval1D(np.asarray(cfg.grid_t, dtype=np.float64)) if cfg.grid_t is not None
          else Interval1D.uniform(cfg.t_start, cfg.t_final, cfg.n_elements_t))
    return TensorMesh2D(axis_x=ax, axis_y=at)


def build(
    cfg: AdvDiffConfig,
    rng: np.random.Generator | None = None,
    lift_fn=None,
    envelope_fn=None,
    u_fn=None,
    f_fn=None,
    velocity_fn=None,
    epsilon_fn=None,
    ic_fn=None,
    *,
    device=None,
) -> Problem:
    """The AdvDiff hp-VPINN problem on `device` (default: the card; pass
    device="cpu" for the CPU).  The positional arguments are the JAX
    package's:

    - `cfg.hard_bc` (or `lift_fn`/`envelope_fn`, torch functions [P, 2] ->
      [P, 1]) switches on the lifted ansatz u = g + D N: the IC and BC hold
      exactly, and the data loss reduces to the sensors.  The defaults fit
      the benchmark problem (default_lift / make_default_envelope).
    - `u_fn(x, t)` replaces the exact solution everywhere (data, test grid,
      `exact`); `f_fn(X, T)` is a forcing projected offline onto the test
      basis; `velocity_fn(x)` is the true advection field of forward runs
      (trainable runs start from cfg.velocity_init); `epsilon_fn(x)` the
      true diffusion field, whose exact domain mean becomes eps_true.
      make_manufactured gives a consistent (u_fn, f_fn) pair.
    - `ic_fn(x)` is the initial edge of a time slab (cfg.t_start > 0).

    deriv_mode "taylor" takes the fields from the plain Taylor propagation,
    "pallas" from the fused CUDA kernels (var_form 0: B1 with second
    derivatives, u_yy dropped, and B2 with a zero cotangent on it; forms 1
    and 2: B1 firsts-only), which take float32 on a CUDA device (their plain
    versions run on the CPU), and "jvp" from the JVP engine on the ansatz,
    which hard_bc and layer_feature force.
    """
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"deriv_mode must be one of {sorted(_FIELDS)}; got {cfg.deriv_mode!r}")
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    eps_true = _domain_mean(epsilon_fn, *cfg.domain_x) if epsilon_fn is not None else cfg.gamma / np.pi
    mesh = _mesh(cfg)
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)

    ntx = (np.asarray(cfg.n_test_x_per_elem) if cfg.n_test_x_per_elem is not None
           else np.full(mesh.axis_x.n_elem, cfg.n_test_x))
    ntt = (np.asarray(cfg.n_test_t_per_elem) if cfg.n_test_t_per_elem is not None
           else np.full(mesh.axis_y.n_elem, cfg.n_test_t))
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype, device)
    bt = make_weighted_basis(int(ntt.max()), xq, wq, dtype, device)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, f_fn, ntx, ntt, dtype, device)

    Xb, ub = training_data(cfg, rng, u_data_fn=u_fn, ic_fn=ic_fn)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_t": bt,
        "xb": torch.as_tensor(Xb).to(device=device, dtype=dtype),
        "ub": torch.as_tensor(ub).to(device=device, dtype=dtype),
    }

    var_form, wb, V = cfg.var_form, cfg.lossb_weight, cfg.velocity
    inverse = cfg.inverse
    mode = cfg.deriv_mode

    # The outflow boundary-layer input feature: the steady layer profile
    # exp(V (x - x_out)/eps) as a third network input (the exact solution
    # has a layer of width eps/V at the outflow wall).
    feature_fn = None
    layers = cfg.layers
    if cfg.layer_feature:
        if inverse:
            raise ValueError(
                "layer_feature builds the outflow profile from the true eps, a forward-problem tool only "
                "(it would leak the answer into an inverse run's ansatz); set inverse=False"
            )
        xl_, xr_ = cfg.domain_x
        if velocity_fn is not None:
            v_out = float(np.asarray(velocity_fn(np.asarray([xr_], dtype=np.float64)))[0])
            if v_out < 0:
                v_out = float(np.asarray(velocity_fn(np.asarray([xl_], dtype=np.float64)))[0])
        else:
            v_out = float(V)
        out_wall = xr_ if v_out >= 0 else xl_
        sgn = 1.0 if v_out >= 0 else -1.0
        delta = float(cfg.layer_feature_scale) if cfg.layer_feature_scale is not None else eps_true / max(abs(v_out), 1e-12)

        def feature_fn(X, _w=out_wall, _d=delta, _s=sgn):
            return torch.exp(_s * (X[:, 0:1] - _w) / _d)  # <= 1 in the domain, decays inward

        layers = (layers[0] + 1,) + tuple(layers[1:])
        mode = "jvp"  # augmented-input ansatz: the JVP engine

    spec = MLP(layers=layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    hard_bc = cfg.hard_bc or lift_fn is not None or envelope_fn is not None
    if hard_bc:
        if ic_fn is not None or cfg.t_start != 0.0:
            raise ValueError(
                "hard_bc's lifted ansatz interpolates the analytic IC at t = 0; time-slab runs "
                "(t_start > 0 or a handed-off ic_fn) need soft BC"
            )
        if u_fn is not None and lift_fn is None:
            raise ValueError(
                "hard_bc with a manufactured u_fn needs an explicit lift_fn: the default lift "
                "interpolates the benchmark's -sin(pi x) IC"
            )
        mode = "jvp"  # composite ansatz: the JVP engine
        composite = make_composite_apply(spec, lift_fn or default_lift, envelope_fn or make_default_envelope(cfg),
                                         feature_fn=feature_fn)
    elif feature_fn is not None:
        feature_apply = make_feature_apply(spec, feature_fn)

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        if feature_fn is not None:
            return feature_apply(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    eps_model = cfg.epsilon_model
    if eps_model not in ("scalar", "quadratic", "mlp"):
        raise ValueError(f"epsilon_model must be 'scalar', 'quadratic' or 'mlp'; got {eps_model!r}")
    eps_spec = MLP(layers=cfg.epsilon_mlp_layers, activation="tanh") if eps_model == "mlp" else None
    vel_model = cfg.velocity_model
    if vel_model not in ("scalar", "linear", "quadratic"):
        raise ValueError(f"velocity_model must be 'scalar', 'linear' or 'quadratic'; got {vel_model!r}")
    n_vel_coef = {"linear": 2, "quadratic": 3}.get(vel_model, 0)

    def leaf(value):
        return nn.Parameter(torch.tensor(value, dtype=dtype, device=device))

    def pde_init():
        if not inverse:
            return {}
        pde = {}
        if eps_model == "quadratic":
            pde["eps_coef"] = leaf([cfg.epsilon_init, 0.0, 0.0])
        elif eps_model == "mlp":
            # A neural eps(x) started near-flat at epsilon_init: the output
            # layer shrunk by 0.01 and its bias shifted to epsilon_init,
            # drawn from the train seed + 101 (pde_init takes no generator).
            net = init_mlp(eps_spec, torch.Generator().manual_seed(cfg.train.seed + 101), dtype=dtype, device=device)
            with torch.no_grad():
                net[-1]["W"].mul_(0.01)
                net[-1]["b"].add_(cfg.epsilon_init)
            pde["eps_net"] = net
        else:
            pde["epsilon"] = leaf(cfg.epsilon_init)
        if cfg.velocity_trainable:
            if n_vel_coef:
                pde["vel_coef"] = leaf([cfg.velocity_init] + [0.0] * (n_vel_coef - 1))
            else:
                pde["velocity"] = leaf(cfg.velocity_init)
        return pde

    def v_of(params, x):
        """The advection velocity at points x: the constant V, a trainable
        scalar, a trainable polynomial v0 + v1 x (+ v2 x^2), or the true
        manufactured field (forward runs with velocity_fn)."""
        if inverse and cfg.velocity_trainable:
            if n_vel_coef:
                c = params["pde"]["vel_coef"]
                v = c[0] + c[1] * x
                if n_vel_coef == 3:
                    v = v + c[2] * x * x
                return v
            return params["pde"]["velocity"]
        if velocity_fn is not None:
            return velocity_fn(x)
        return V

    def eps_net_at(params, x):
        return mlp_apply(eps_spec, params["pde"]["eps_net"], x)

    def eps_of(params, x):
        """Scalar or field eps(x) from the trainable PDE leaves (forward
        runs: the true field or scalar)."""
        if not inverse:
            return epsilon_fn(x) if epsilon_fn is not None else eps_true
        if eps_model == "quadratic":
            c = params["pde"]["eps_coef"]
            return c[0] + c[1] * x + c[2] * x * x
        if eps_model == "mlp":
            return eps_net_at(params, x.reshape(-1, 1)).reshape(x.shape)
        return params["pde"]["epsilon"]

    def eps_x_of(params, x):
        """d(eps)/dx, the extra term of form 1 for a variable eps: analytic
        for the quadratic, the JVP engine for the network and for a true
        epsilon_fn."""
        if inverse and eps_model == "quadratic":
            c = params["pde"]["eps_coef"]
            return c[1] + 2.0 * c[2] * x
        if inverse and eps_model == "mlp":
            flat = x.reshape(-1, 1)
            return dir_deriv(lambda z: eps_net_at(params, z), flat, torch.ones_like(flat)).reshape(x.shape)
        if not inverse and epsilon_fn is not None:
            return dir_deriv(epsilon_fn, x, torch.ones_like(x))
        return 0.0

    a_dom, b_dom = cfg.domain_x
    _mx = 0.5 * (a_dom + b_dom)
    _mx2 = (a_dom * a_dom + a_dom * b_dom + b_dom * b_dom) / 3.0
    if eps_model == "mlp":
        _eps_mean_grid = torch.as_tensor(np.linspace(a_dom, b_dom, 257).reshape(-1, 1)).to(device=device, dtype=dtype)

    def eps_domain_mean(params):
        """The exact domain average of eps(x) (the network's on a uniform
        257-point grid; GLJ points cluster at the edges)."""
        if not inverse:
            return eps_true
        if eps_model == "quadratic":
            c = params["pde"]["eps_coef"]
            return c[0] + c[1] * _mx + c[2] * _mx2
        if eps_model == "mlp":
            return torch.mean(eps_net_at(params, _eps_mean_grid))
        return params["pde"]["epsilon"]

    def vel_domain_mean(params):
        """The exact domain average of the (possibly trainable) velocity."""
        if inverse and cfg.velocity_trainable:
            if n_vel_coef:
                c = params["pde"]["vel_coef"]
                v = c[0] + c[1] * _mx
                if n_vel_coef == 3:
                    v = v + c[2] * _mx2
                return v
            return params["pde"]["velocity"]
        if velocity_fn is not None:
            return _domain_mean(velocity_fn, a_dom, b_dom)
        return V

    fields = _FIELDS[mode]

    def residual_at(params, el, basis_x, basis_t):
        fields_fn = None if fields is None else (lambda x, y, **kw: fields(spec, params["net"], x, y, **kw))
        return advdiff_residual(
            make_u_fn(params), el, basis_x, basis_t, var_form, v_of(params, el.x), eps_of(params, el.x),
            fields_fn=fields_fn, epsilon_x=eps_x_of(params, el.x),
        )

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r]."""
        el = data["elements"]
        return residual_at(params, el, data["basis_x"], data["basis_t"]) * el.mask

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_2d, mesh, xq, wq, f_fn, (int(ntx.max()), int(ntt.max())), dtype=dtype, device=device))

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes not in the training
        basis: hierarchical a-posteriori estimation (see
        adaptive.element_indicator), on the training fields path.  Returns
        [E, K+enrich, R+enrich] with the trained block zeroed."""
        bx_en, bt_en, elems_en, new = enriched(enrich)
        return residual_at(params, elems_en, bx_en, bt_en) * new[None]

    regularized = inverse and cfg.epsilon_reg > 0 and eps_model in ("quadratic", "mlp")
    n_reg = elems.x.numel()  # the Tikhonov mean's count: every point of the unsharded elements
    n_quad_x = elems.x.shape[-1]  # the fast axis's unpadded points

    def _real(el):
        """1 on the elements of a shard, 0 on the padding (mask 0 throughout),
        broadcast over their points."""
        real = (el.mask.reshape(el.mask.shape[0], -1) != 0).any(dim=1).to(el.x.dtype)
        return real.reshape(-1, *([1] * (el.x.dim() - 1)))

    def _real_points(el, points):
        """_real, and on a point axis (`points`) 0 on the fast axis's
        columns past the unpadded Q: the fast axis is padded to a multiple
        of the axis's size (parallel/sharding.py::pad_points) with
        edge-copied coordinates."""
        real = _real(el)
        if points is not None:
            q = el.x.shape[-1]
            real = real * (torch.arange(points.index * q, (points.index + 1) * q, device=el.x.device) < n_quad_x)
        return real

    def reg_sum(params, data):
        """sum(eps_x^2) over this rank's real points of its real elements
        (over the point group too)."""
        el = data["elements"]
        ex = eps_x_of(params, el.x) * torch.ones_like(el.x)
        points = points_of(data["basis_x"].wphi)
        total = torch.sum(ex * ex * _real_points(el, points))
        return total if points is None else psum(total, points)

    def loss_fn(params, data, axis_name=None):
        """lossb_weight lossb + lossv (AdvDiff.py:180-184), plus the
        Tikhonov term epsilon_reg mean(eps_x^2) on a field eps.  The aux
        keys: loss, lossb, lossv and, when inverse, epsilon (its domain
        mean), eps_c1/eps_c2 (quadratic), velocity and vel_c1/vel_c2
        (trainable velocity): 0-d tensors of the problem's dtype.  Under
        `axis_name` (an element Axis, parallel/sharding.py) lossv and the
        Tikhonov term, a mean over the elements' points, are summed over
        the ranks, and lossb counted once."""
        el = data["elements"]
        res = residual_at(params, el, data["basis_x"], data["basis_t"])
        lossv = variational_loss(res, el.mask, el.n_test)
        lossb = torch.mean((data["ub"] - make_u_fn(params)(data["xb"])) ** 2)
        if axis_name is not None:
            lossv, lossb = psum(lossv, axis_name), once(lossb, axis_name)
        loss = wb * lossb + lossv
        if regularized:
            if axis_name is None:
                loss = loss + cfg.epsilon_reg * torch.mean(eps_x_of(params, el.x) ** 2)
            else:
                loss = loss + cfg.epsilon_reg * psum(reg_sum(params, data), axis_name) / n_reg
        aux = {"loss": loss, "lossb": lossb, "lossv": lossv}
        if inverse:
            aux["epsilon"] = eps_domain_mean(params)
            if eps_model == "quadratic":
                aux["eps_c1"] = params["pde"]["eps_coef"][1]
                aux["eps_c2"] = params["pde"]["eps_coef"][2]
            if cfg.velocity_trainable:
                aux["velocity"] = vel_domain_mean(params)
                if n_vel_coef:
                    aux["vel_c1"] = params["pde"]["vel_coef"][1]
                    if n_vel_coef == 3:
                        aux["vel_c2"] = params["pde"]["vel_coef"][2]
        return loss, aux

    if regularized:
        def reg_resvec_fn(params, data, axis_name=None):
            """The Tikhonov term as least-squares residuals: sum(r^2) equals
            loss_fn's regularization term (for the Gauss-Newton phase).
            Under `axis_name` the rows of this rank's points of its
            elements, those of padded elements and padded point columns
            zero."""
            el = data["elements"]
            ex = eps_x_of(params, el.x) * torch.ones_like(el.x)
            if axis_name is not None:
                ex = ex * _real_points(el, points_of(data["basis_x"].wphi))
            return np.sqrt(cfg.epsilon_reg / n_reg) * ex.reshape(-1)

        reg_resvec_fn.element_rows = True  # its rows follow the elements (training/gauss_newton.py)
    else:
        reg_resvec_fn = None

    # Dense space-time test grid: 256 x-points, time step 0.01 (AdvDiff.py:448-450).
    xt = np.linspace(cfg.domain_x[0], cfg.domain_x[1], 256)
    tt = np.arange(cfg.t_start, cfg.t_final + 0.01, 0.01)
    XT, TT = np.meshgrid(xt, tt)
    test_points = np.stack([XT.reshape(-1), TT.reshape(-1)], axis=-1)
    if u_fn is None:
        exact = lambda x, t: u_exact(x, t, eps_true, cfg.velocity, cfg.fourier_terms)  # noqa: E731
    else:
        exact = u_fn
    test_values = exact(test_points[:, 0:1], test_points[:, 1:2])

    # The scalar "true velocity" report: the domain mean of a manufactured
    # field, else the reference's constant V.
    velocity_true = _domain_mean(velocity_fn, a_dom, b_dom) if velocity_fn is not None else cfg.velocity

    return Problem(
        name="advdiff",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype, device=device),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if (hard_bc or feature_fn is not None) else None,
        exact=exact,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "reg_resvec_fn": reg_resvec_fn,
            "eps_true": eps_true,
            "eps_of": eps_of,
            "eps_domain_mean": eps_domain_mean,
            "v_of": v_of,
            "vel_domain_mean": vel_domain_mean,
            "velocity_true": velocity_true,
            "velocity_fn": velocity_fn,
            "epsilon_fn": epsilon_fn,
            "f_rhs": f_fn,
            "test_grid_shape": (len(tt), len(xt)),
        },
    )
