"""Port parity, the direct solvers (hpvpinns_tpu_torch/galerkin.py) and the
adaptive loops that put them in the solve slot (adaptive_galerkin_*):
every solver against the JAX package's on the same inputs at a small p,
every optimization-gap report from one JAX parameter draw, in float64 on
the CPU.

The solvers are the same numpy/scipy arithmetic in both packages (the
port's meshes are its own classes): their solutions agree to rtol 1e-12.
The gap reports read the network through each package's predict: rtol
1e-10.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import adaptive as jad  # noqa: E402
from hpvpinns_tpu import galerkin as jg  # noqa: E402
from hpvpinns_tpu.geometry import mesh as jm  # noqa: E402
from hpvpinns_tpu_torch import adaptive as tad  # noqa: E402
from hpvpinns_tpu_torch import galerkin as tg  # noqa: E402
from hpvpinns_tpu_torch.geometry import mesh as tm  # noqa: E402
from test_torch_parity import family_case, one_torch_thread  # noqa: E402

SOLVE = dict(rtol=1e-12)
GAP = dict(rtol=1e-10)
PACKAGES = {"jax": (jg, jm), "port": (tg, tm)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def close(actual, desired, tol):
    desired = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(actual, desired, atol=1e-13 * max(np.abs(desired).max(), 1e-300), **tol)


def u2(x, y):
    return np.sin(np.pi * x) * np.cos(y) + x * y


def lap_u2(x, y):
    return -(np.pi**2 + 1.0) * np.sin(np.pi * x) * np.cos(y)


def kovasznay_uv(x, y, re=40.0):
    lam = re / 2.0 - np.sqrt(re * re / 4.0 + 4.0 * np.pi**2)
    ex = np.exp(lam * x)
    return 1.0 - ex * np.cos(2.0 * np.pi * y), (lam / (2.0 * np.pi)) * ex * np.sin(2.0 * np.pi * y)


def taylorgreen_uv(x, y, t, nu=0.5):
    e = np.exp(-2.0 * nu * t)
    return -np.cos(x) * np.sin(y) * e, np.sin(x) * np.cos(y) * e


def solve_case(name, g, m):
    """One solve at a small p on a non-uniform mesh, and its solution at a
    grid of points (a flat numpy array)."""
    xs = np.linspace(-1.0, 1.0, 17)
    ax = m.Interval1D(np.array([-1.0, -0.2, 0.3, 1.0]))
    ay = m.Interval1D.uniform(-1.0, 1.0, 2)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    if name == "poisson1d":
        sol = g.solve_poisson1d(ax, 6, lambda x: np.pi**2 * np.sin(np.pi * x) + x, (0.2, -0.3))
        return np.concatenate([sol(xs), sol.derivative(xs)])
    if name == "poisson2d":
        mesh = m.TensorMesh2D(axis_x=ax, axis_y=ay)
        return g.solve_poisson2d(mesh, 5, lap_u2, lift_fn=g.coons_lift(u2, (-1.0, 1.0), (-1.0, 1.0)))(X, Y)
    if name == "coons_lift":
        return g.coons_lift(u2, (-1.0, 1.0), (-1.0, 1.0))(X, Y)
    if name == "helmholtz2d":
        mesh = m.TensorMesh2D(axis_x=ax, axis_y=ay)
        return g.solve_helmholtz2d(mesh, 5, 4.0, lambda x, y: lap_u2(x, y) + 4.0 * u2(x, y),
                                   lift_fn=g.coons_lift(u2, (-1.0, 1.0), (-1.0, 1.0)))(X, Y)
    if name == "poisson3d":
        mesh = m.TensorMesh3D(axis_x=ax, axis_y=ay, axis_z=m.Interval1D.uniform(-1.0, 1.0, 1))
        u3 = lambda x, y, z: np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z) + x  # noqa: E731
        f3 = lambda x, y, z: -3 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)  # noqa: E731
        x3 = np.linspace(-1.0, 1.0, 5)
        X3, Y3, Z3 = np.meshgrid(x3, x3, x3, indexing="ij")
        return g.solve_poisson3d(mesh, 4, f3, lift_fn=u3)(X3, Y3, Z3)
    ts = np.array([0.0, 0.1, 0.3])
    XT, TT = np.meshgrid(xs, ts, indexing="ij")
    u0 = lambda x: -np.sin(np.pi * x)  # noqa: E731
    if name == "advdiff":
        return g.solve_advdiff(ax, 5, u0, 0.05, 1.0)(XT, TT)
    if name == "advdiff_fields":
        # eps(x), V(x) and a forcing: d(eps)/dx through JAX's jvp / torch.func.jvp
        return g.solve_advdiff(ax, 5, u0, lambda x: 0.05 + 0.02 * x * x, lambda x: 1.0 + 0.3 * x,
                               f_fn=lambda x, t: np.exp(-t) * np.cos(np.pi * x / 2), n_quad_t=8)(XT, TT)
    if name == "advdiff2d":
        x2 = np.linspace(-1.0, 1.0, 7)
        X2, Y2, T2 = np.meshgrid(x2, x2, ts, indexing="ij")
        u02 = lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y)  # noqa: E731
        f_sep = lambda x, y, t: np.exp(-t) * u02(x, y)  # noqa: E731
        f_gen = lambda x, y, t: (1.0 + t) * u02(x, y)  # noqa: E731
        return np.concatenate([
            g.solve_advdiff2d(ax, ay, 4, u02, 0.05, 0.5, -0.3, f_fn=f_sep)(X2, Y2, T2).reshape(-1),
            g.solve_advdiff2d(ax, ay, 3, u02, 0.05, 0.5, -0.3, f_fn=f_gen, n_quad_t=4)(X2, Y2, T2).reshape(-1),
        ])
    if name == "burgers":
        return g.solve_burgers(ax, 5, u0, 0.05, 0.3, 20)(XT, TT)
    if name == "ns_steady":
        sol = g.solve_ns_steady((-0.5, 1.0), (-0.5, 1.5), 6, 1.0 / 40.0, kovasznay_uv)
        XN, YN = np.meshgrid(np.linspace(-0.5, 1.0, 9), np.linspace(-0.5, 1.5, 9), indexing="ij")
        return np.concatenate([sol(XN, YN).reshape(-1), [sol.newton_iters]])
    if name == "ns_unsteady":
        sol = g.solve_ns_unsteady((0.0, np.pi), (0.0, np.pi), 5, 0.5, taylorgreen_uv,
                                  lambda x, y: taylorgreen_uv(x, y, 0.0), t_final=0.2, n_steps=4)
        XN, YN, TN = np.meshgrid(np.linspace(0, np.pi, 7), np.linspace(0, np.pi, 7), [0.05, 0.2], indexing="ij")
        u, v = sol.velocity(XN, YN, TN)
        return np.concatenate([u.reshape(-1), v.reshape(-1), sol.pressure(XN, YN, TN).reshape(-1)])
    raise KeyError(name)


SOLVES = ["poisson1d", "poisson2d", "coons_lift", "helmholtz2d", "poisson3d", "advdiff", "advdiff_fields",
          "advdiff2d", "burgers", "ns_steady", "ns_unsteady"]


@pytest.mark.parametrize("name", SOLVES)
def test_solver_matches_jax(name, monkeypatch):
    """Each solver's solution at a grid of points.  For a callable eps(x)
    JAX's solve_advdiff takes d(eps)/dx from jax.jvp inside
    jax.experimental.enable_x64, which JAX 0.9 removed: it then falls back
    to a central difference (rounding ~1e-10 relative).  The test restores
    the exact path (x64 is on in these tests already), which the port's
    torch.func.jvp matches."""
    import contextlib

    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", contextlib.nullcontext, raising=False)
    want = solve_case(name, *PACKAGES["jax"])
    got = solve_case(name, *PACKAGES["port"])
    assert got.shape == want.shape and np.all(np.isfinite(got))
    close(got, want, SOLVE)


def test_solver_errors_match_jax():
    for g, m in PACKAGES.values():
        with pytest.raises(ValueError, match="degree"):
            g.solve_poisson1d(m.Interval1D.uniform(0, 1, 2), 0, lambda x: x, (0, 0))
        with pytest.raises(ValueError, match="degree"):
            g.solve_advdiff(m.Interval1D.uniform(0, 1, 2), 0, lambda x: x, 0.1, 1.0)
    assert tg.BURGERS_SOLVER_GRID == jg.BURGERS_SOLVER_GRID


def test_exp_decay_detection_matches_jax():
    X = np.linspace(-1.0, 1.0, 9)
    for f in (lambda x, t: np.exp(-0.7 * t) * np.sin(np.pi * x), lambda x, t: (1 + t) * np.sin(np.pi * x)):
        assert tg._detect_exp_decay(f, (X,)) == jg._detect_exp_decay(f, (X,))


# (package function, family of test_torch_parity.FAMILIES, small solve
# arguments) for every gap report; Poisson-3D has its own tiny config.
GAPS = {
    "vpinn_gap_1d": ("poisson1d", dict(p=8, n_points=101)),
    "vpinn_gap_2d": ("poisson2d", dict(p=4, n_points=11)),
    "vpinn_gap_helmholtz2d": ("helmholtz2d", dict(p=6, n_points=11)),
    "vpinn_gap_advdiff": ("advdiff", dict(p=6, n_points=11)),
    "vpinn_gap_advdiff2d": ("advdiff2d", dict(p=3, n_points=5)),
    "vpinn_gap_burgers": ("burgers", dict(p=5, n_steps=20)),
    "vpinn_gap_3d": ("poisson3d", dict(p=3, n_points=5)),
    "vpinn_gap_kovasznay": ("kovasznay", dict(p=6, n_points=11)),
    "vpinn_gap_taylorgreen": ("taylorgreen", dict(p=4, n_steps=4, n_points=5)),
}
P3D = dict(n_elements_x=2, n_elements_y=1, n_elements_z=1, n_quad=4, n_test_x=3, n_test_y=3, n_test_z=3,
           layers=(3, 6, 6, 1), n_bound=8, dtype="float64")


def gap_case(family):
    if family != "poisson3d":
        return family_case(family)
    jprob = jv.build(jv.Poisson3DConfig(**P3D))
    jparams = jprob.init_params(jax.random.key(0))
    tparams = tv.params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float64)
    return jprob, jparams, tv.build(tv.Poisson3DConfig(**P3D), device="cpu"), tparams


@pytest.mark.parametrize("fn", sorted(GAPS))
def test_vpinn_gap_matches_jax(fn):
    """The three rel-L2 of a gap report (and Kovasznay's Newton count) from
    the JAX draw: the network through each package's predict, the direct
    solve in numpy on both sides."""
    family, kw = GAPS[fn]
    jprob, jparams, tprob, tparams = gap_case(family)
    want = getattr(jg, fn)(jprob, jparams, **kw)
    got = getattr(tg, fn)(tprob, tparams, **kw)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], value, err_msg=key, **GAP)


def test_vpinn_gap_rejects_other_problems():
    _, _, tprob, tparams = family_case("poisson2d")
    for fn in ("vpinn_gap_advdiff", "vpinn_gap_advdiff2d", "vpinn_gap_burgers", "vpinn_gap_3d",
               "vpinn_gap_kovasznay", "vpinn_gap_taylorgreen"):
        with pytest.raises(ValueError, match="supports"):
            getattr(tg, fn)(tprob, tparams)
    with pytest.raises(TypeError, match="1D problems"):
        tg.vpinn_gap_1d(tprob, tparams)


def records_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if key in ("eta", "rel_l2"):
                close(np.asarray(g[key]), value, SOLVE)
            else:
                assert g[key] == value, key


def test_adaptive_galerkin_1d_matches_jax():
    """Three rounds on the steep Poisson-1D from two elements: the same
    grids, eta and rel-L2 per round."""
    kw = dict(dtype="float64", n_elements=2, n_quad=10, n_test=4, layers=(1, 4, 1))
    want = jad.adaptive_galerkin_1d(jv.Poisson1DConfig(**kw), rounds=3, p=6, enrich=2)
    got = tad.adaptive_galerkin_1d(tv.Poisson1DConfig(**kw), rounds=3, p=6, enrich=2,
                                   build_fn=functools.partial(tv.build, device="cpu"))
    records_close(got, want)
    assert got[-1]["n_elem"] > got[0]["n_elem"]


def test_adaptive_galerkin_2d_matches_jax():
    kw = dict(dtype="float64", n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 4, 1))
    want = jad.adaptive_galerkin_2d(jv.Poisson2DConfig(**kw), rounds=2, p=4, enrich=1)
    got = tad.adaptive_galerkin_2d(tv.Poisson2DConfig(**kw), rounds=2, p=4, enrich=1,
                                   build_fn=functools.partial(tv.build, device="cpu"))
    records_close(got, want)


def test_adaptive_galerkin_advdiff_matches_jax(monkeypatch):
    """adaptive_galerkin_advdiff builds with the package's build (on the card
    by default): the test builds on the CPU."""
    monkeypatch.setattr(tad, "build", functools.partial(tv.build, device="cpu"))
    kw = dict(dtype="float64", n_quad=6, n_test_x=3, n_test_t=3, layers=(2, 4, 1), t_final=0.3, fourier_terms=50)
    want = jad.adaptive_galerkin_advdiff(jv.AdvDiffConfig(**kw), rounds=2, p=5, enrich=2, n_eval_t=3)
    got = tad.adaptive_galerkin_advdiff(tv.AdvDiffConfig(**kw), rounds=2, p=5, enrich=2, n_eval_t=3)
    records_close(got, want)


def test_adaptive_galerkin_burgers_matches_jax():
    kw = dict(dtype="float64", t_final=0.5)
    want = jad.adaptive_galerkin_burgers(jv.BurgersConfig(**kw), rounds=2, p=5, enrich=2, n_steps=20, n_eval_t=3)
    got = tad.adaptive_galerkin_burgers(tv.BurgersConfig(**kw), rounds=2, p=5, enrich=2, n_steps=20, n_eval_t=3)
    records_close(got, want)


def test_adaptive_galerkin_rejects_other_configs():
    for fn, cfg in (("adaptive_galerkin_1d", tv.Poisson2DConfig()), ("adaptive_galerkin_2d", tv.Poisson1DConfig()),
                    ("adaptive_galerkin_advdiff", tv.BurgersConfig()), ("adaptive_galerkin_burgers", tv.AdvDiffConfig())):
        with pytest.raises(TypeError, match="supports"):
            getattr(tad, fn)(cfg)
