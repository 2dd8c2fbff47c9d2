"""Port parity, the inverse suite (hpvpinns_tpu_torch/inverse.py) against
hpvpinns_tpu/inverse.py: the same problems built by both packages from the
same configs and seeds (the same sensors and noise), the same numpy
parameters through params_from_jax, float64 on the CPU.

Sizes are far below the JAX package's own tests (those take minutes each):
the whole routes run at small p, few iterations and loose xatol, and the
inner maps of the long routes (the prediction closure, the misfit's
gradient, the Jacobian) are held at a small p.  chip_smoke.py phase 21 runs
the routes at the JAX tests' sizes on the card.

Tolerances: the linear fits (coefficients, the assembled system, residual
norms) to 1e-10 relative: the same arithmetic, the port's contractions
batched over the columns; ALS to 1e-9 (two rounds of lstsq on nearly
singular systems); the searches (Brent, Nelder-Mead) on the same misfits
equal to 1e-12, since they take the same steps; reduced_identify_field's
prediction to 1e-12 and the misfit's gradient to 1e-10 (the port's
matrix_exp is a Taylor/scaling-squaring scheme, JAX's expm a Pade one: they
round differently), its L-BFGS-B estimate after 3 iterations to 1e-8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import inverse as JI  # noqa: E402
from hpvpinns_tpu.problems import advdiff as jadv  # noqa: E402
from hpvpinns_tpu_torch import inverse as TI  # noqa: E402
from hpvpinns_tpu_torch.problems import advdiff as tadv  # noqa: E402

LINEAR = dict(rtol=1e-10, atol=1e-13)
SEARCH = dict(rtol=1e-12, atol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: under xdist the workers' threads spin on each
    other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eps_true(x):
    """The sin diffusivity field of the JAX tests, in numpy, jax or torch."""
    sin = torch.sin if isinstance(x, torch.Tensor) else (jnp.sin if isinstance(x, jax.Array) else np.sin)
    return (0.1 / np.pi) * (1.0 + 0.5 * sin(np.pi * x))


def oracle(X):
    """The manufactured "cos" solution cos(pi x / 2) e^{-t}, torch or jax."""
    m = torch if isinstance(X, torch.Tensor) else jnp
    return m.cos(np.pi / 2 * X[:, 0:1]) * m.exp(-X[:, 1:2])


def manufactured(velocity=lambda x: 1.0 + 0.3 * x, with_eps=False, **kw):
    """(jax problem, port problem) of the manufactured AdvDiff family with
    the sin eps(x) truth and the "cos" profile, from one config."""
    out = []
    for pkg, mod, extra in ((jv, jadv, {}), (tv, tadv, {"device": "cpu"})):
        cfg = pkg.AdvDiffConfig(dtype="float64", **kw)
        u_fn, f_fn = mod.make_manufactured(cfg, velocity, epsilon=eps_true, profile="cos")
        out.append(mod.build(cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=velocity,
                             epsilon_fn=eps_true if with_eps else None, **extra))
    return out


def pair(cls, **kw):
    """(jax problem, port problem) of config class `cls` in float64."""
    return jv.build(getattr(jv, cls)(dtype="float64", **kw)), tv.build(getattr(tv, cls)(dtype="float64", **kw),
                                                                        device="cpu")


@pytest.fixture(scope="module")
def fit_pair():
    return manufactured(n_quad=12, n_test_x=6, n_test_t=6)


@pytest.fixture(scope="module")
def bench_pair():
    """The benchmark AdvDiff problem (the reference's 15 sensors)."""
    return pair("AdvDiffConfig")


@pytest.fixture(scope="module")
def sparse_pair():
    """7 x 5 sensors, the reduced field route's regime."""
    return manufactured(velocity=lambda x: 1.0 + 0.0 * x, with_eps=True, n_quad=6, n_test_x=3, n_test_t=3,
                        sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 7)),
                        n_sensors_per_station=5)


def test_legendre_field_matches_jax():
    coef = np.array([0.3, -0.2, 0.05, 0.01])
    x = np.linspace(0.0, 2.0, 17)
    np.testing.assert_allclose(TI.legendre_field(coef, (0.0, 2.0))(x), JI.legendre_field(coef, (0.0, 2.0))(x),
                               rtol=1e-15, atol=0.0)
    np.testing.assert_allclose(TI.legendre_field(np.array([2.0, 0.5]), (0.0, 2.0))(np.array([0.0, 1.0, 2.0])),
                               [1.5, 2.0, 2.5])


@pytest.mark.parametrize("reg", [0.0, 10.0])
def test_fit_epsilon_field_oracle_matches_jax(fit_pair, reg):
    """The oracle u through each package's own fields: coefficients, the
    raw system A, b, the residual norms and the Tikhonov Gram."""
    jp, tp = fit_pair
    jc, jf, ji = JI.fit_epsilon_field(jp, jp.init_params(jax.random.key(0)), order=6, reg=reg, u_fn=oracle)
    tc, tf, ti = TI.fit_epsilon_field(tp, tp.init_params(torch.Generator().manual_seed(0)), order=6, reg=reg,
                                      u_fn=oracle)
    np.testing.assert_allclose(tc, jc, **LINEAR)
    for k in ("A", "b") + (("reg_gram",) if reg else ()):
        np.testing.assert_allclose(ti[k], ji[k], **LINEAR, err_msg=k)
    for k in ("residual_before", "residual_after"):  # the oracle's residual is at the rounding floor
        np.testing.assert_allclose(ti[k], ji[k], rtol=1e-9, atol=1e-12 * ji["residual_before"], err_msg=k)
    assert ti["order"] == 6 and (ti["reg_gram"] is None) == (reg == 0)
    xs = np.linspace(-1.0, 1.0, 33)
    np.testing.assert_allclose(tf(xs), jf(xs), **LINEAR)


def test_fit_epsilon_field_on_a_jax_trained_network():
    """A network trained in JAX (40 Adam steps of an inverse run with a
    neural eps(x) and a trainable velocity) moved to the port by
    params_from_jax: each package evaluates u through its own JVP engine
    and V through its own v_of, and the fits agree to 1e-10."""
    kw = dict(n_quad=8, n_test_x=5, n_test_t=4, layers=(2, 8, 8, 1), epsilon_model="mlp", epsilon_reg=1e-2,
              velocity_trainable=True, velocity_init=0.8)
    jp, tp = manufactured(**kw, train=jv.TrainConfig(iterations=40, check_every=20))
    res = jv.train(jp, verbose=False)
    tparams = tv.params_from_jax(jax.tree.map(np.asarray, res.params), dtype=torch.float64)
    jc, _, ji = JI.fit_epsilon_field(jp, res.params, order=5, reg=1e-3)
    tc, _, ti = TI.fit_epsilon_field(tp, tparams, order=5, reg=1e-3)
    np.testing.assert_allclose(ti["A"], ji["A"], **LINEAR)
    np.testing.assert_allclose(ti["b"], ji["b"], **LINEAR)
    np.testing.assert_allclose(tc, jc, **LINEAR)


@pytest.mark.parametrize("vel_order", [0, 2])
def test_fit_coefficient_fields_matches_jax(fit_pair, vel_order):
    jp, tp = fit_pair
    j = JI.fit_coefficient_fields(jp, jp.init_params(jax.random.key(0)), eps_order=5, vel_order=vel_order,
                                  reg=1e-6, u_fn=oracle)
    t = TI.fit_coefficient_fields(tp, tp.init_params(torch.Generator().manual_seed(0)), eps_order=5,
                                  vel_order=vel_order, reg=1e-6, u_fn=oracle)
    np.testing.assert_allclose(t[0], j[0], **LINEAR)
    if vel_order:
        np.testing.assert_allclose(t[2], j[2], **LINEAR)
        xs = np.linspace(-1.0, 1.0, 9)
        np.testing.assert_allclose(t[3](xs), j[3](xs), **LINEAR)
    else:
        assert t[2] is None and t[3] is None
    for k in ("residual_before", "residual_after"):
        np.testing.assert_allclose(t[4][k], j[4][k], rtol=1e-8, atol=1e-12 * j[4]["residual_before"], err_msg=k)


def test_als_identify_matches_jax():
    """Two ALS rounds at a cut basis on dense clean sensors (9 x 8): the
    coefficient history, the field and the recovered u_fn."""
    jp, tp = manufactured(velocity=lambda x: 1.0 + 0.0 * x, with_eps=True, n_quad=14, n_test_x=10, n_test_t=8,
                          sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 9)),
                          n_sensors_per_station=8)
    kw = dict(space_order=8, time_order=6, eps_order=5, iters=2)
    ju, jc, jf, ji = JI.als_identify(jp, **kw)
    tu, tc, tf, ti = TI.als_identify(tp, **kw)
    np.testing.assert_allclose(np.asarray(ti["eps_coef_history"]), np.asarray(ji["eps_coef_history"]),
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(tc, jc, rtol=1e-9, atol=1e-13)
    X = tp.test_points[::97]
    np.testing.assert_allclose(tu(X), ju(X), rtol=1e-9, atol=1e-12)
    assert {k: v for k, v in ti.items() if k != "eps_coef_history"} == {
        k: v for k, v in ji.items() if k != "eps_coef_history"}


def test_als_identify_warns_on_a_trainable_velocity():
    """The velocity is read from the problem's draw: velocity_init on a
    trainable-velocity problem, with JAX's warning."""
    jp, tp = pair("AdvDiffConfig", inverse=True, velocity_trainable=True, n_quad=6, n_test_x=3, n_test_t=3)
    kw = dict(space_order=3, time_order=3, eps_order=2, iters=1)
    with pytest.warns(UserWarning, match="velocity_trainable=True"):
        _, jc, _, _ = JI.als_identify(jp, **kw)
    with pytest.warns(UserWarning, match="velocity_trainable=True"):
        _, tc, _, _ = TI.als_identify(tp, **kw)
    np.testing.assert_allclose(tc, jc, rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("kw", [
    dict(p=10, xatol=1e-6),
    dict(p=8, eps_order=2, maxiter=20),
    dict(p=8, identify_velocity=True, maxiter=30),
], ids=["brent", "nelder-mead-field", "joint-eps-velocity"])
def test_reduced_identify_matches_jax(bench_pair, kw):
    """The benchmark's 15 sensors: Brent for the scalar, Nelder-Mead for a
    2-mode field and for the joint (eps, V), each on the same misfit."""
    jp, tp = bench_pair
    jc, jf, ji = JI.reduced_identify(jp, **kw)
    tc, tf, ti = TI.reduced_identify(tp, **kw)
    np.testing.assert_allclose(tc, jc, **SEARCH)
    assert ti.keys() == ji.keys() and ti["n_solves"] == ji["n_solves"] and ti["method"] == ji["method"]
    np.testing.assert_allclose(ti["misfit"], ji["misfit"], **SEARCH)
    if "velocity" in ji:
        np.testing.assert_allclose(ti["velocity"], ji["velocity"], **SEARCH)
    np.testing.assert_allclose(tf(np.zeros(3)), jf(np.zeros(3)), **SEARCH)


def test_reduced_identify2d_matches_jax():
    jp, tp = pair("AdvDiff2DConfig", n_quad=6, n_test_x=3, n_test_y=3, n_test_t=3)
    jc, ji = JI.reduced_identify2d(jp, p=4, maxiter=20)
    tc, ti = TI.reduced_identify2d(tp, p=4, maxiter=20)
    np.testing.assert_allclose(tc, jc, **SEARCH)
    assert ti == pytest.approx(ji, rel=1e-12)


def _misfit_and_grad_jax(predict, ds, s):
    return jax.value_and_grad(lambda z: jnp.sum((predict(z) - ds) ** 2))(jnp.asarray(s))


def _misfit_and_grad_torch(predict, ds, s):
    z = torch.tensor(s, requires_grad=True)
    m = torch.sum((predict(z) - torch.as_tensor(ds)) ** 2)
    return m, torch.autograd.grad(m, z)[0]


@pytest.mark.parametrize("forced", [True, False], ids=["manufactured", "homogeneous"])
def test_reduced_identify_field_maps_match_jax(sparse_pair, bench_pair, forced):
    """At p 8: the prediction closure, the misfit and its gradient (the
    adjoint through matrix_exp) at a fixed s, and the whole route for 3
    L-BFGS-B iterations.  "manufactured": separable forcing (the
    (A + rate I)^-1 term); "homogeneous": the benchmark's f = 0."""
    jp, tp = sparse_pair if forced else bench_pair
    kw = dict(eps_order=4, p=8, maxiter=3)
    js, jf, ji = JI.reduced_identify_field(jp, **kw)
    ts, tf, ti = TI.reduced_identify_field(tp, **kw)
    np.testing.assert_allclose(ts, js, rtol=1e-8, atol=1e-10)
    assert ti["n_evals"] == ji["n_evals"] and ti["n_sensors"] == ji["n_sensors"] and ti["method"] == ji["method"]
    np.testing.assert_array_equal(ti["sensor_values"], ji["sensor_values"])
    s = np.array([np.log(0.03), 0.1, -0.05, 0.02])
    np.testing.assert_allclose(ti["predict"](torch.tensor(s)).numpy(), np.asarray(ji["predict"](jnp.asarray(s))),
                               rtol=1e-12, atol=1e-12)
    jm, jg = _misfit_and_grad_jax(ji["predict"], ji["sensor_values"], s)
    tm, tg = _misfit_and_grad_torch(ti["predict"], ti["sensor_values"], s)
    np.testing.assert_allclose(float(tm.detach()), float(jm), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10 * float(np.abs(jg).max()))
    xs = np.linspace(-1.0, 1.0, 9)
    np.testing.assert_allclose(tf(xs), jf(xs), rtol=1e-8)


def test_reduced_identify_burgers_matches_jax():
    """Seeded sensors with noise (numpy default_rng, JAX's draws) and the
    Brent search at p 6, 30 steps."""
    jp, tp = pair("BurgersConfig")
    kw = dict(p=6, n_steps=30, xatol=1e-5, noise=1e-3, seed=3)
    jn, ji = JI.reduced_identify_burgers(jp, **kw)
    tn, ti = TI.reduced_identify_burgers(tp, **kw)
    np.testing.assert_allclose(tn, jn, **SEARCH)
    assert ti == pytest.approx(ji, rel=1e-12)


def test_fit_epsilon_field2d_oracle_matches_jax():
    jp, tp = pair("AdvDiff2DConfig", n_quad=6, n_test_x=3, n_test_y=3, n_test_t=3)

    def u2d(X):
        m = torch if isinstance(X, torch.Tensor) else jnp
        return m.sin(np.pi * X[:, 0:1]) * m.sin(np.pi * X[:, 1:2]) * m.exp(-X[:, 2:3])

    jc, jf, ji = JI.fit_epsilon_field2d(jp, jp.init_params(jax.random.key(0)), order_x=3, order_y=3, u_fn=u2d)
    tc, tf, ti = TI.fit_epsilon_field2d(tp, tp.init_params(torch.Generator().manual_seed(0)), order_x=3,
                                        order_y=3, u_fn=u2d)
    np.testing.assert_allclose(tc, jc, rtol=1e-10, atol=1e-12 * np.abs(jc).max())
    X, Y = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 4))
    np.testing.assert_allclose(tf(X, Y), jf(X, Y), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ti["residual_before"], ji["residual_before"], rtol=1e-12)
    assert (ti["order_x"], ti["order_y"]) == (3, 3)


def test_als_identify2d_matches_jax():
    jp, tp = pair("AdvDiff2DConfig", n_quad=8, n_test_x=5, n_test_y=5, n_test_t=4)
    kw = dict(space_order=3, time_order=3, eps_order=2, iters=2)
    ju, jc, jf, ji = JI.als_identify2d(jp, **kw)
    tu, tc, tf, ti = TI.als_identify2d(tp, **kw)
    np.testing.assert_allclose(tc, jc, rtol=1e-9, atol=1e-13)
    X = tp.test_points[::131]
    np.testing.assert_allclose(tu(X), ju(X), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tf(X[:, 0], X[:, 1]), jf(X[:, 0], X[:, 1]), rtol=1e-9, atol=1e-13)
    assert ti == ji


@pytest.mark.parametrize("cls,route,kw", [
    ("KovasznayConfig", "reduced_identify_kovasznay", dict(p=6, xatol=1e-5)),
    ("TaylorGreenConfig", "reduced_identify_taylorgreen", dict(p=4, n_steps=8, xatol=1e-5)),
    ("Helmholtz2DConfig", "reduced_identify_helmholtz", dict(p=6, n_scan=7, xatol=1e-5)),
])
@pytest.mark.parametrize("own_sensors", [True, False], ids=["problem-sensors", "sampled-noisy"])
def test_reduced_identify_families_match_jax(cls, route, kw, own_sensors):
    """The NS and Helmholtz scalar routes on the problem's own inverse
    sensors, or on sensors sampled by the route (seeded, with noise)."""
    jp, tp = pair(cls, inverse=own_sensors)
    if not own_sensors:
        kw = dict(kw, noise=1e-3, seed=5)
    jv_, ji = getattr(JI, route)(jp, **kw)
    tv_, ti = getattr(TI, route)(tp, **kw)
    np.testing.assert_allclose(tv_, jv_, **SEARCH)
    assert ti == pytest.approx(ji, rel=1e-12)


@pytest.mark.parametrize("route,kw", [
    ("fit_epsilon_field", {"params": None}), ("fit_coefficient_fields", {"params": None}),
    ("als_identify", {}), ("reduced_identify", {}), ("reduced_identify_field", {}),
])
def test_advdiff_routes_refuse_other_families(route, kw):
    p1 = tv.build(tv.Poisson1DConfig(dtype="float64"), device="cpu")
    with pytest.raises(ValueError, match="advdiff"):
        getattr(TI, route)(p1, **kw)


@pytest.mark.parametrize("route,family", [
    ("reduced_identify2d", "advdiff2d"), ("fit_epsilon_field2d", "advdiff2d"), ("als_identify2d", "advdiff2d"),
    ("reduced_identify_burgers", "burgers"), ("reduced_identify_kovasznay", "kovasznay"),
    ("reduced_identify_taylorgreen", "taylorgreen"), ("reduced_identify_helmholtz", "helmholtz2d"),
])
def test_family_routes_refuse_other_families(route, family):
    p1 = tv.build(tv.Poisson1DConfig(dtype="float64"), device="cpu")
    args = (p1, None) if route == "fit_epsilon_field2d" else (p1,)
    with pytest.raises(ValueError, match=family):
        getattr(TI, route)(*args)


def test_reduced_identify_checks_eps_order_with_velocity(bench_pair):
    tp = bench_pair[1]
    with pytest.raises(ValueError, match="eps_order"):
        TI.reduced_identify(tp, eps_order=2, identify_velocity=True)
