"""Viscous Burgers equation, the nonlinear space-time family.

Counterpart of hpvpinns_tpu/problems/burgers.py:

    u_t + u u_x = nu u_xx   on (x, t) in [-1, 1] x [0, T]
    u(x, 0) = -sin(pi x),  u(+-1, t) = 0

The convection term is assembled in conservation form (ops/assembly.py::
burgers_residual).  The exact solution is the Cole-Hopf transformation,
evaluated by Gauss-Hermite quadrature:

    u(x, t) = -2 nu d/dx log phi,   phi = the heat-kernel convolution of
    exp(-(1 - cos(pi x)) / (2 pi nu)),

a ratio of two Hermite sums after the substitution eta = x - 2 sqrt(nu t) z.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hpvpinns_tpu_torch.config import BurgersConfig
from hpvpinns_tpu_torch.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply
from hpvpinns_tpu_torch.ops.assembly import burgers_residual, variational_loss
from hpvpinns_tpu_torch.ops.fields import scalar_fields_2d
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_2d
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d
from hpvpinns_tpu_torch.parallel.sharding import once, psum
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


def u_initial(x):
    return -np.sin(np.pi * x)


def u_exact(x, t, nu, n_hermite: int = 128):
    """Cole-Hopf solution by Gauss-Hermite quadrature (float64 host math);
    -sin(pi x) at t = 0.  log(w) is folded into the exponent before the
    per-point maximum is taken off, so the largest term of the denominator
    is exactly 1 and the ratio stays finite at nu = 0.01/pi, where the
    bare exponent's maximum can sit on a tail node whose weight underflows."""
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    x, t = np.broadcast_arrays(x, t)
    z, w = np.polynomial.hermite.hermgauss(n_hermite)
    xc = x.reshape(-1, 1)
    tc = np.maximum(t.reshape(-1, 1), 1e-30)  # t = 0 rows replaced below
    eta = xc - 2.0 * np.sqrt(nu * tc) * z[None, :]
    log_f = -np.cos(np.pi * eta) / (2.0 * np.pi * nu)
    e = np.log(w)[None, :] + log_f
    f = np.exp(e - e.max(axis=1, keepdims=True))
    num = np.sum(np.sin(np.pi * eta) * f, axis=1)
    den = np.sum(f, axis=1)
    u = (-num / den).reshape(x.shape)
    return np.where(t == 0, u_initial(x), u)


def default_lift(X):
    """g(x, t) = -sin(pi x): exact on the IC and on both walls."""
    return -torch.sin(np.pi * X[:, 0:1])


@functools.lru_cache(maxsize=8)
def _hermite(n_hermite: int, dtype, device):
    """Gauss-Hermite nodes and log-weights on `device`, made once: an ansatz
    that calls u_exact_torch inside a captured CUDA graph (a time slab's
    lift) finds them there, and copies nothing from the host during the
    capture."""
    z, w = np.polynomial.hermite.hermgauss(n_hermite)
    return (torch.as_tensor(z, dtype=dtype, device=device),
            torch.as_tensor(np.log(w), dtype=dtype, device=device))


def u_exact_torch(x, t, nu, n_hermite: int = 96):
    """u_exact in torch operations, for use inside an ansatz (the
    counterpart of u_exact_jnp): x [P, 1], t > 0 a number or a tensor
    broadcastable to x.  log(w) is taken in host float64 before the cast
    (the tail weights underflow float32, their logs do not), and the
    per-point maximum taken off the exponent is a constant for autograd."""
    z, lw = _hermite(n_hermite, x.dtype, x.device)
    eta = x - 2.0 * (nu * t) ** 0.5 * z[None, :]
    e = lw[None, :] - torch.cos(np.pi * eta) / (2.0 * np.pi * nu)
    f = torch.exp(e - e.max(dim=1, keepdim=True).values.detach())
    num = torch.sum(torch.sin(np.pi * eta) * f, dim=1, keepdim=True)
    den = torch.sum(f, dim=1, keepdim=True)
    return -num / den


def make_interface_lift(u0_fn, domain_x):
    """Hard-BC lift of a time slab from its start-face state (the JAX
    package's make_interface_lift, problems/burgers.py:106-135).
    `u0_fn(x) -> [n, 1]` (torch operations) is the slab's initial condition:
    a previous slab's trained ansatz at the interface time in a time march,
    or u_exact_torch at t0 for the exact restart.  The lift is constant in t,

        g(x, t) = u0(x) - [(1 - s) u0(a) + s u0(b)],   s = (x - a)/(b - a),

    u0 minus its linear wall interpolant: zero on both walls for all t, and
    u0 on the start face up to u0's own wall residue (none when the previous
    slab was itself hard-BC, so hard-BC slabs chain with an exact handoff).
    Pair it with make_default_envelope(slab config), whose time factor
    vanishes at the slab's own t_start."""
    a, b = domain_x

    def lift(X):
        x = X[:, 0:1]
        u0 = u0_fn(x)
        ua = u0_fn(torch.full((1, 1), a, dtype=X.dtype, device=X.device))
        ub = u0_fn(torch.full((1, 1), b, dtype=X.dtype, device=X.device))
        s = (x - a) / (b - a)
        return u0 - ((1.0 - s) * ua + s * ub)

    return lift


def make_default_envelope(cfg: BurgersConfig, rate: float = 4.0):
    """(x - a)(b - x)/((b - a)/2)^2 (1 - exp(-rate (t - t0)/(T - t0))): it
    vanishes on both walls and on the slab's initial face t = t_start."""
    a, b = cfg.domain_x
    scale = ((b - a) / 2.0) ** 2
    t0, span = cfg.t_start, cfg.t_final - cfg.t_start

    def envelope(X):
        tfac = 1.0 - torch.exp(-rate * (X[:, 1:2] - t0) / span)
        return (X[:, 0:1] - a) * (b - X[:, 0:1]) / scale * tfac

    return envelope


def training_data(cfg: BurgersConfig, rng: np.random.Generator, ic_fn=None):
    """Both walls and the initial edge, LHS-sampled from `rng` in the JAX
    package's order.  The initial edge sits at t = t_start with values
    ic_fn(x) (host numpy, [n, 1] -> [n, 1]) when given, else the Cole-Hopf
    solution at t_start (-sin(pi x) at t_start = 0)."""
    T0, T, (xl, xr) = cfg.t_start, cfg.t_final, cfg.domain_x
    n = cfg.n_bound
    t_up = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    t_lo = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    x_in = lhs_interval(xl, xr, n, rng)
    pts = [
        np.hstack([np.full_like(t_up, xr), t_up]),
        np.hstack([np.full_like(t_lo, xl), t_lo]),
        np.hstack([x_in, np.full_like(x_in, T0)]),
    ]
    if ic_fn is not None:
        u0 = np.asarray(ic_fn(x_in)).reshape(n, 1)
    elif T0 == 0.0:
        u0 = u_initial(x_in)
    else:
        u0 = u_exact(x_in, np.full_like(x_in, T0), cfg.nu)
    return np.concatenate(pts), np.concatenate([np.zeros((n, 1)), np.zeros((n, 1)), u0])


def _mesh(cfg: BurgersConfig) -> TensorMesh2D:
    if cfg.grid_x is None and cfg.grid_t is None:
        return TensorMesh2D.uniform(*cfg.domain_x, cfg.n_elements_x, cfg.t_start, cfg.t_final, cfg.n_elements_t)

    def axis(grid, lo, hi, n):
        return Interval1D(np.asarray(grid, dtype=np.float64)) if grid is not None else Interval1D.uniform(lo, hi, n)

    return TensorMesh2D(axis_x=axis(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
                        axis_y=axis(cfg.grid_t, cfg.t_start, cfg.t_final, cfg.n_elements_t))


def build(
    cfg: BurgersConfig,
    rng: np.random.Generator | None = None,
    lift_fn=None,
    envelope_fn=None,
    ic_fn=None,
    *,
    device=None,
) -> Problem:
    """The Burgers problem on `device` (default: the card; pass device="cpu"
    for the CPU).  The positional arguments are the JAX package's: `rng`
    draws the training data (and the collocation points of n_strong),
    `lift_fn` / `envelope_fn` (torch functions [P, 2] -> [P, 1]) switch on
    the hard-BC ansatz u = lift + envelope * N with their own lift or
    envelope (cfg.hard_bc takes default_lift and make_default_envelope), and
    `ic_fn` hands in the initial edge's values of a time slab.

    deriv_mode "taylor" takes the fields from the plain Taylor propagation,
    "pallas" from the fused CUDA kernels at n_dirs 2 (form 1: B1
    firsts-only; form 0: B1 with second derivatives, u_tt dropped, and B2
    with a zero cotangent on it), which take float32 on a CUDA device
    (their plain versions run on the CPU), and "jvp" from the JVP engine on
    the ansatz, which hard BC and front_feature force.  The strong residual
    of n_strong always takes the JVP engine, as the JAX package's does."""
    if cfg.deriv_mode not in _FIELDS:
        raise ValueError(f"deriv_mode must be one of {sorted(_FIELDS)}; got {cfg.deriv_mode!r}")
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    rng = rng or np.random.default_rng(cfg.train.seed)
    if (cfg.hard_bc or envelope_fn is not None) and lift_fn is None and (ic_fn is not None or cfg.t_start != 0.0):
        raise ValueError(
            "hard_bc's default lift interpolates the analytic -sin(pi x) IC at t = 0; a time-slab run "
            "(t_start > 0 or a handed-off ic_fn) needs an explicit lift_fn built from the slab's own start face"
        )
    mesh = _mesh(cfg)
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = (np.asarray(cfg.n_test_x_per_elem) if cfg.n_test_x_per_elem is not None
           else np.full(mesh.axis_x.n_elem, cfg.n_test_x))
    ntt = (np.asarray(cfg.n_test_t_per_elem) if cfg.n_test_t_per_elem is not None
           else np.full(mesh.axis_y.n_elem, cfg.n_test_t))
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype, device)
    bt = make_weighted_basis(int(ntt.max()), xq, wq, dtype, device)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, None, ntx, ntt, dtype, device)

    def on_device(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    Xb, ub = training_data(cfg, rng, ic_fn=ic_fn)
    data = {"elements": elems, "basis_x": bx, "basis_t": bt, "xb": on_device(Xb), "ub": on_device(ub)}
    n_strong = cfg.n_strong
    if n_strong > 0:
        xlw, xrw = cfg.strong_window or cfg.domain_x
        xs = lhs_interval(xlw, xrw, n_strong, rng)
        ts = cfg.t_start + (cfg.t_final - cfg.t_start) * lhs_interval(0.0, 1.0, n_strong, rng)
        data["xr"] = on_device(np.hstack([xs, ts]))

    var_form, wb, nu = cfg.var_form, cfg.lossb_weight, cfg.nu
    mode = cfg.deriv_mode
    # front_feature: tanh(x / delta) as an extra network input (the front
    # forms and stays at x = 0); the JAX package measured it negative on the
    # precision preset and keeps it as a control.
    feature_fn = None
    layers = cfg.layers
    if cfg.front_feature:
        delta = float(cfg.front_feature_scale) if cfg.front_feature_scale is not None else 2.0 * nu

        def feature_fn(X, _d=delta):
            return torch.tanh(X[:, 0:1] / _d)

        layers = (layers[0] + 1,) + tuple(layers[1:])
        mode = "jvp"  # augmented-input ansatz: the JVP engine

    spec = MLP(layers=layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    hard_bc = cfg.hard_bc or lift_fn is not None or envelope_fn is not None
    if hard_bc:
        mode = "jvp"  # composite ansatz: the JVP engine
        composite = make_composite_apply(spec, lift_fn or default_lift, envelope_fn or make_default_envelope(cfg),
                                         feature_fn=feature_fn)
    elif feature_fn is not None:
        feature_apply = make_feature_apply(spec, feature_fn)
    fields = _FIELDS[mode]

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        if feature_fn is not None:
            return feature_apply(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def weak_residual(params, el, basis_x, basis_t):
        fields_fn = None if fields is None else (lambda x, y, **kw: fields(spec, params["net"], x, y, **kw))
        return burgers_residual(make_u_fn(params), el, basis_x, basis_t, var_form, nu, fields_fn=fields_fn)

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r]."""
        el = data["elements"]
        return weak_residual(params, el, data["basis_x"], data["basis_t"]) * el.mask

    enriched = functools.lru_cache(maxsize=None)(functools.partial(
        build_enriched_2d, mesh, xq, wq, None, (int(ntx.max()), int(ntt.max())), dtype=dtype, device=device))

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes not in the training
        basis: hierarchical a-posteriori estimation for the nonlinear family
        (see adaptive.element_indicator), on the training fields path.
        Returns [E, K+enrich, R+enrich] with the trained block zeroed."""
        bx_en, bt_en, elems_en, new = enriched(enrich)
        return weak_residual(params, elems_en, bx_en, bt_en) * new[None]

    def strong_res(params, Xr):
        """Pointwise u_t + u u_x - nu u_xx through the full ansatz (the JVP
        engine)."""
        f = scalar_fields_2d(make_u_fn(params), Xr[:, 0], Xr[:, 1], first_y_only=True)
        return f["uy"] + f["u"] * f["ux"] - nu * f["uxx"]

    ws = cfg.strong_weight

    def loss_fn(params, data, axis_name=None):
        """lossb_weight lossb + lossv (+ strong_weight lossr with n_strong);
        aux {loss, lossb, lossv(, lossr)}: 0-d tensors of the problem's
        dtype.  Under `axis_name` lossv is summed over the ranks, lossb
        (the initial and boundary data) and lossr counted once."""
        el = data["elements"]
        lossv = variational_loss(weak_residual(params, el, data["basis_x"], data["basis_t"]), el.mask, el.n_test)
        lossb = torch.mean((data["ub"] - make_u_fn(params)(data["xb"])) ** 2)
        if axis_name is not None:
            lossv, lossb = psum(lossv, axis_name), once(lossb, axis_name)
        loss = wb * lossb + lossv
        aux = {"lossb": lossb, "lossv": lossv}
        if n_strong > 0:
            lossr = torch.mean(strong_res(params, data["xr"]) ** 2)
            if axis_name is not None:
                lossr = once(lossr, axis_name)
            loss = loss + ws * lossr
            aux["lossr"] = lossr
        aux["loss"] = loss
        return loss, aux

    # Dense space-time test grid: 256 x-points, time step 0.01.
    xt = np.linspace(cfg.domain_x[0], cfg.domain_x[1], 256)
    tt = np.arange(cfg.t_start, cfg.t_final + 0.01, 0.01)
    XT, TT = np.meshgrid(xt, tt)
    test_points = np.stack([XT.reshape(-1), TT.reshape(-1)], axis=-1)
    test_values = u_exact(test_points[:, 0:1], test_points[:, 1:2], nu)

    return Problem(
        name="burgers",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype, device=device),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if (hard_bc or feature_fn is not None) else None,
        exact=lambda x, t: u_exact(x, t, nu),
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(tt), len(xt)),
            # Gauss-Newton's residual hook: the strong-collocation block, scaled
            # so that sum(r^2) is the loss's strong_weight mean(strong^2)
            **({"reg_resvec_fn": lambda params, data: np.sqrt(ws / data["xr"].shape[0])
                * strong_res(params, data["xr"]).reshape(-1)} if n_strong > 0 else {}),
        },
    )
