"""Port parity, the inverse suite's error bars
(hpvpinns_tpu_torch/uncertainty.py) against hpvpinns_tpu/uncertainty.py:
the same problems from the same configs and seeds, float64 on the CPU, at
sizes far below the JAX package's tests (small p, few expansions and
replicates); chip_smoke.py phase 21 runs the intervals at the routes' own
sizes on the card.

Tolerances: the closed forms and the finite-difference Gauss-Newton
intervals to 1e-10 relative (the same host arithmetic on the same forward
solves); reduced_field_ci's Jacobian, taken by torch.func.jacfwd through
matrix_exp where JAX takes jax.jacfwd through a Pade expm, to 1e-9 of its
largest entry and its covariance and band to 1e-8 (S'S squares the
Jacobian's condition); the bootstrap (numpy default_rng, the same draws)
to 1e-9."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import inverse as JI  # noqa: E402
from hpvpinns_tpu import uncertainty as JU  # noqa: E402
from hpvpinns_tpu_torch import inverse as TI  # noqa: E402
from hpvpinns_tpu_torch import uncertainty as TU  # noqa: E402

CLOSED = dict(rtol=1e-10, atol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(cls, **kw):
    return jv.build(getattr(jv, cls)(dtype="float64", **kw)), tv.build(getattr(tv, cls)(dtype="float64", **kw),
                                                                        device="cpu")


def assert_ci_equal(t, j, rtol=1e-10):
    """Two interval dicts: the same keys, lists and flags, numbers to rtol."""
    assert t.keys() == j.keys()
    for k in j:
        if isinstance(j[k], (bool, str)) or k in ("params", "n_sensors"):
            assert t[k] == j[k], k
        else:
            np.testing.assert_allclose(np.asarray(t[k], dtype=float), np.asarray(j[k], dtype=float), rtol=rtol,
                                       atol=0.0, err_msg=k)


@pytest.fixture(scope="module")
def noisy_advdiff():
    """The benchmark AdvDiff problem with 1e-3 sensor noise (the JAX test's
    calibration case; the noise drawn from the same spawned generator)."""
    return pair("AdvDiffConfig", sensor_noise_std=1e-3)


@pytest.fixture(scope="module")
def noisy_advdiff2d():
    return pair("AdvDiff2DConfig", sensor_noise_std=1e-3, n_quad=6, n_test_x=3, n_test_y=3, n_test_t=3)


@pytest.mark.parametrize("regularized", [False, True])
def test_lstsq_covariance_matches_jax(regularized):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(60, 8)) @ np.diag(1.0 / (1 + np.arange(8)) ** 2)
    b = A @ rng.normal(size=8) + 0.05 * rng.normal(size=60)
    G = 1e-2 * np.trace(A.T @ A) / 8 * np.eye(8) if regularized else None
    c = np.linalg.solve(A.T @ A + (G if regularized else 0.0), A.T @ b)
    (jc, js), (tc, ts) = JU.lstsq_covariance(A, b, c, reg_gram=G), TU.lstsq_covariance(A, b, c, reg_gram=G)
    np.testing.assert_allclose(tc, jc, **CLOSED)
    assert ts == pytest.approx(js, rel=1e-14)


def test_legendre_field_band_matches_jax():
    coef = np.array([1.0, 0.5, 0.25])
    cov = np.array([[0.02, 0.001, 0.0], [0.001, 0.01, -0.002], [0.0, -0.002, 0.005]])
    x = np.linspace(0.0, 2.0, 7)
    np.testing.assert_allclose(TU.legendre_field_band(coef, cov, (0.0, 2.0))(x),
                               JU.legendre_field_band(coef, cov, (0.0, 2.0))(x), **CLOSED)
    np.testing.assert_allclose(TU.legendre_field_band(coef, np.zeros((3, 3)))(x[:3]), 0.0)


@pytest.mark.parametrize("kw", [dict(), dict(velocity=1.0), dict(noise_std=1e-3)],
                         ids=["epsilon", "epsilon-velocity", "crlb"])
def test_reduced_scalar_ci_matches_jax(noisy_advdiff, kw):
    """At the true epsilon, p 10: S by central differences of the same
    forward solves."""
    jp, tp = noisy_advdiff
    et = [jp.extras["eps_true"]]
    assert_ci_equal(TU.reduced_scalar_ci(tp, et, p=10, **kw), JU.reduced_scalar_ci(jp, et, p=10, **kw))


@pytest.mark.parametrize("noise_std", [None, 1e-3])
def test_reduced_scalar_ci2d_matches_jax(noisy_advdiff2d, noise_std):
    jp, tp = noisy_advdiff2d
    truth = [jp.extras["eps_true"], *jp.config.velocity]
    t = TU.reduced_scalar_ci2d(tp, truth, p=4, noise_std=noise_std)
    assert_ci_equal(t, JU.reduced_scalar_ci2d(jp, truth, p=4, noise_std=noise_std))
    assert t["params"] == ["epsilon", "vx", "vy"]


def test_profile_eps_ci2d_matches_jax(noisy_advdiff2d):
    """One outward step a side, then the bisection, each over the inner
    Nelder-Mead on the same misfits: the same interval and solve count."""
    jp, tp = noisy_advdiff2d
    truth = [jp.extras["eps_true"], *jp.config.velocity]
    j = JU.profile_eps_ci2d(jp, truth, p=3, noise_std=1e-3, max_expand=1)
    t = TU.profile_eps_ci2d(tp, truth, p=3, noise_std=1e-3, max_expand=1)
    assert t["n_profile"] == j["n_profile"]
    np.testing.assert_allclose(t["eps_ci95"], j["eps_ci95"], rtol=1e-10)
    np.testing.assert_allclose([t["sigma"], t["misfit_min"]], [j["sigma"], j["misfit_min"]], rtol=1e-12)
    with pytest.raises(ValueError, match="full"):
        TU.profile_eps_ci2d(tp, truth[:1], p=3)


@pytest.fixture(scope="module")
def field_infos():
    """Both packages' reduced_identify_field infos (their predict closures)
    at p 8 on 7 x 5 noisy sensors."""
    kw = dict(sensor_noise_std=1e-3, n_quad=6, n_test_x=3, n_test_t=3,
              sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 7)))
    jp, tp = pair("AdvDiffConfig", **kw)
    return (JI.reduced_identify_field(jp, eps_order=4, p=8, maxiter=1)[2],
            TI.reduced_identify_field(tp, eps_order=4, p=8, maxiter=1)[2])


@pytest.mark.parametrize("noise_std", [None, 1e-3])
def test_reduced_field_ci_matches_jax(field_infos, noise_std):
    """The Fisher band from each package's own predict closure at one s: the
    Jacobian (torch.func.jacfwd against jax.jacfwd), sigma, the covariance
    and the band."""
    ji, ti = field_infos
    s = np.array([np.log(0.03), 0.1, -0.05, 0.02])
    Sj = np.asarray(jax.jacfwd(ji["predict"])(jnp.asarray(s)))
    St = torch.func.jacfwd(ti["predict"])(torch.tensor(s)).numpy()
    np.testing.assert_allclose(St, Sj, rtol=0.0, atol=1e-9 * np.abs(Sj).max())
    j = JU.reduced_field_ci(s, ji, domain=(-1.0, 1.0), noise_std=noise_std)
    t = TU.reduced_field_ci(s, ti, domain=(-1.0, 1.0), noise_std=noise_std)
    assert (t["n_sensors"], t["crlb"]) == (j["n_sensors"], j["crlb"]) == (35, noise_std is not None)
    np.testing.assert_allclose(t["sigma"], j["sigma"], rtol=1e-10)
    np.testing.assert_allclose(t["cov_s"], j["cov_s"], rtol=1e-8, atol=1e-8 * np.abs(j["cov_s"]).max())
    xs = np.linspace(-0.9, 0.9, 11)
    np.testing.assert_allclose(t["std_fn"](xs), j["std_fn"](xs), rtol=1e-8)


def test_als_bootstrap_matches_jax():
    """Two replicates of a cut ALS on the manufactured dense-sensor problem:
    the same resamples (numpy default_rng(seed)), so the same samples."""
    from hpvpinns_tpu.problems import advdiff as jadv
    from hpvpinns_tpu_torch.problems import advdiff as tadv

    def eps(x):
        return (0.1 / np.pi) * (1.0 + 0.5 * (torch.sin(np.pi * x) if isinstance(x, torch.Tensor)
                                             else (jnp.sin if isinstance(x, jax.Array) else np.sin)(np.pi * x)))

    probs = []
    for pkg, mod, extra in ((jv, jadv, {}), (tv, tadv, {"device": "cpu"})):
        cfg = pkg.AdvDiffConfig(dtype="float64", n_quad=10, n_test_x=6, n_test_t=5, sensor_noise_std=1e-3,
                                sensor_stations=tuple(float(s) for s in np.linspace(-0.9, 0.9, 7)),
                                n_sensors_per_station=6)
        u_fn, f_fn = mod.make_manufactured(cfg, lambda x: 1.0 + 0.0 * x, epsilon=eps, profile="cos")
        probs.append(mod.build(cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=lambda x: 1.0 + 0.0 * x, epsilon_fn=eps,
                               **extra))
    jp, tp = probs
    kw = dict(space_order=5, time_order=4, eps_order=3, iters=2)
    ju, jc, _, _ = JI.als_identify(jp, **kw)
    tu, tc, _, _ = TI.als_identify(tp, **kw)
    j = JU.als_bootstrap(jp, jc, ju, n_boot=2, seed=4, **kw)
    t = TU.als_bootstrap(tp, tc, tu, n_boot=2, seed=4, **kw)
    assert t["n_boot"] == j["n_boot"] == 2
    np.testing.assert_allclose(t["coef_samples"], j["coef_samples"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(t["coef_std"], j["coef_std"], rtol=1e-8, atol=1e-13)
    xs = np.linspace(-1.0, 1.0, 9)
    np.testing.assert_allclose(t["std_fn"](xs), j["std_fn"](xs), rtol=1e-8, atol=1e-13)
    assert tp.data["ub"].dtype == torch.float64  # the problem's own data is left as it was


@pytest.mark.parametrize("cls,route,ci,kw_route,kw_ci", [
    ("KovasznayConfig", "reduced_identify_kovasznay", "reduced_ns_ci", dict(p=6, xatol=1e-5), dict(p=6)),
    ("TaylorGreenConfig", "reduced_identify_taylorgreen", "reduced_ns_unsteady_ci",
     dict(p=4, n_steps=8, xatol=1e-5), dict(p=4, n_steps=8)),
    ("Helmholtz2DConfig", "reduced_identify_helmholtz", "reduced_helmholtz_ci",
     dict(p=6, n_scan=7, xatol=1e-5), dict(p=6)),
])
@pytest.mark.parametrize("noise_std", [None, 1e-3])
def test_scalar_family_cis_match_jax(cls, route, ci, kw_route, kw_ci, noise_std):
    """The NS and Helmholtz intervals at JAX's estimate, on the problem's
    own inverse sensors (the unsteady one with its Richardson debias)."""
    jp, tp = pair(cls, inverse=True)
    est, _ = getattr(JI, route)(jp, **kw_route)
    j = getattr(JU, ci)(jp, est, noise_std=noise_std, **kw_ci)
    t = getattr(TU, ci)(tp, est, noise_std=noise_std, **kw_ci)
    assert_ci_equal(t, j)


def test_unsteady_ci_without_debias_matches_jax():
    jp, tp = pair("TaylorGreenConfig", inverse=True)
    kw = dict(p=4, n_steps=8, debias=False)
    t = TU.reduced_ns_unsteady_ci(tp, 0.1, **kw)
    assert "bias" not in t
    assert_ci_equal(t, JU.reduced_ns_unsteady_ci(jp, 0.1, **kw))
