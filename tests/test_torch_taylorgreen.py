"""Port parity, Taylor-Green (the unsteady Navier-Stokes system): the vector
JVP engine in 3D, the unsteady NS weak residual in forms 0/1, the exact
solution, its torch twin and the space-time Coons lift (with and without an
initial-face hook), the built data (walls and initial face, the anchor
curve, the sensors, the zero-mean gauge's points), the loss, aux and
gradients in every option (soft and hard BC, bc_pressure=False, inverse,
eq_weights, the zero-mean gauge, p_test_enrich), the Gauss-Newton residual
vector with its primal Jacobian, three LM steps, the time-march hooks and
their three ValueErrors, evaluate's component keys and the strong residual,
against the JAX package on the CPU in float64 at a tiny size (a 2x2x2
space-time mesh, 4 quadrature points, 2^3 test functions, a (3,8,8,3) tanh
net), from the same numpy parameters.

Tolerances: the engine and the residual to 1e-12; host arrays to 1e-12
(points bit for bit); loss, aux and gradients to rtol 1e-10; r and J to
rtol 1e-10; LM records to rtol 1e-8; evaluation to rtol 1e-10.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import evaluate as jevaluate  # noqa: E402
from hpvpinns_tpu.ops import assembly as jasm  # noqa: E402
from hpvpinns_tpu.ops import fields as jfields  # noqa: E402
from hpvpinns_tpu.problems import taylorgreen as jtg  # noqa: E402
from hpvpinns_tpu_torch.ops import assembly as tasm  # noqa: E402
from hpvpinns_tpu_torch.ops import fields as tfields  # noqa: E402
from hpvpinns_tpu_torch.problems import taylorgreen as ttg  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_gauss_newton import System  # noqa: E402
from test_torch_parity import (  # noqa: E402
    compare_loss_and_grads, jax_loss_and_grads, mlp_pair, one_torch_thread, shared_params, tnp, to_jax, train_gn_tail,
)

jgn = importlib.import_module("hpvpinns_tpu.training.gauss_newton")

TINY = dict(layers=(3, 8, 8, 3), n_quad=4, n_test_x=2, n_test_y=2, n_test_t=2, n_bound=5, n_sensors=6, n_anchor=4,
            n_zero_mean_t=3, dtype="float64")
F64 = dict(rtol=1e-12, atol=1e-14)
LOSS = dict(rtol=1e-10, atol=1e-13)
PI = float(np.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def configs(**kw):
    kw = {**TINY, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return (jv.TaylorGreenConfig(**kw, train=jv.TrainConfig(**tkw)),
            tv.TaylorGreenConfig(**kw, train=tv.TrainConfig(**tkw)))


def build_both(jax_hooks=(), torch_hooks=(), **kw):
    jcfg, tcfg = configs(**kw)
    return jtg.build(jcfg, None, *jax_hooks), ttg.build(tcfg, None, *torch_hooks, device="cpu")


def test_presets_match_jax_fields():
    """The config and both presets field for field (deriv_mode "jvp"); the
    precision preset's LM phase (hard BC, var_form 0, the zero-mean gauge,
    QR) runs in train at a tiny size."""
    for name in ("TaylorGreenConfig", "taylorgreen_quality", "taylorgreen_precision"):
        assert dataclasses.asdict(getattr(tv, name)()) == dataclasses.asdict(getattr(jv, name)()), name
    prob = tv.build(dataclasses.replace(tv.taylorgreen_precision(), **dict(TINY, layers=(3, 6, 3), n_quad=3)),
                    device="cpu")
    train_gn_tail(prob, adam=5)


@pytest.mark.parametrize("second", [True, False])
def test_vector_fields_3d_match_jax(second):
    """Every key and component of the 3D vector engine at [E, Qz, Qy, Qx]
    points (no wzz), to 1e-12."""
    tfn, jfn = mlp_pair((3, 7, 7, 3))
    x, y, z = np.random.default_rng(1).uniform(-1, 1, (3, 2, 3, 4, 5))
    got = tfields.vector_fields_3d(tfn, *(torch.tensor(a) for a in (x, y, z)), second=second)
    want = jfields.vector_fields_3d(jfn, *(jnp.asarray(a) for a in (x, y, z)), second=second)
    assert sorted(got) == sorted(want) == (["w", "wx", "wxx", "wy", "wyy", "wz"] if second else ["w", "wx", "wy", "wz"])
    for k in want:
        assert tuple(got[k].shape) == want[k].shape == (2, 3, 4, 5, 3)
        np.testing.assert_allclose(tnp(got[k]), np.asarray(want[k]), **F64, err_msg=k)


@pytest.mark.parametrize("var_form", [0, 1])
def test_ns_unsteady_residual_matches_jax(var_form):
    """[E, 3, M, K, R] on a non-uniform space-time mesh, nu a number, to
    1e-12; any other form raises JAX's ValueError."""
    jprob, tprob = build_both(grid_x=(0.0, 1.0, PI), grid_t=(0.0, 0.3, 1.0), n_test_x=3)
    tfn, jfn = mlp_pair((3, 7, 7, 3))
    bases = ("basis_x", "basis_y", "basis_t")
    got = tasm.ns_unsteady_residual(tfn, tprob.data["elements"], *(tprob.data[b] for b in bases), var_form, 0.1)
    want = jasm.ns_unsteady_residual(jfn, jprob.data["elements"], *(jprob.data[b] for b in bases), var_form, 0.1)
    assert tuple(got.shape) == want.shape == (8, 3, 2, 2, 3)
    np.testing.assert_allclose(tnp(got), np.asarray(want), **F64)
    with pytest.raises(ValueError, match="unsteady Navier-Stokes var_form must be 0 or 1; got 3"):
        tasm.ns_unsteady_residual(tfn, tprob.data["elements"], *(tprob.data[b] for b in bases), 3, 0.1)


def _ic_pair(t0=0.2):
    """A stand-in for a previous slab's initial u face, equal to the vortex
    on the side walls of [0, pi]^2: (torch map, JAX map)."""
    tu, ju = ttg.exact_uv(10.0)[0], jtg.exact_uv_jnp(10.0)[0]
    return ((lambda x, y: tu(x, y, torch.full_like(x, t0)) + 0.3 * torch.sin(x) * torch.sin(y)),
            (lambda x, y: ju(x, y, jnp.full_like(x, t0)) + 0.3 * jnp.sin(x) * jnp.sin(y)))


@pytest.mark.parametrize("hook", [False, True])
def test_exact_solution_and_spacetime_lift_match_jax(hook):
    """The host solution, its torch twin, and the space-time Coons lift of a
    slab [0.2, 1.0] (with an initial-face hook: it matches the hook at
    t = t_start and the analytic vortex on the side walls)."""
    x, y, t = np.random.default_rng(2).uniform(0.2, 1.0, (3, 9, 1))
    np.testing.assert_array_equal(ttg.exact_stacked(x, y, t.T, 10.0), jtg.exact_stacked(x, y, t.T, 10.0))
    tu, _ = ttg.exact_uv(10.0)
    ju, _ = jtg.exact_uv_jnp(10.0)
    args = [torch.tensor(a) for a in (x, y, t)]
    jargs = [jnp.asarray(a) for a in (x, y, t)]
    np.testing.assert_allclose(tnp(tu(*args)), np.asarray(ju(*jargs)), **F64)
    tic, jic = _ic_pair() if hook else (None, None)
    tl = ttg.coons_lift_spacetime(tu, (0.0, PI), (0.0, PI), 1.0, t_start=0.2, g_ic_fn=tic)
    jl = jtg.coons_lift_spacetime_jnp(ju, (0.0, PI), (0.0, PI), 1.0, t_start=0.2, g_ic_fn=jic)
    np.testing.assert_allclose(tnp(tl(*args)), np.asarray(jl(*jargs)), **F64)
    wall = [torch.tensor(a, dtype=torch.float64)[:, None] for a in ([0.0, PI, 1.3, 0.7], [0.4, 2.0, 0.0, PI],
                                                                    [0.5, 0.9, 0.3, 0.6])]
    np.testing.assert_allclose(tnp(tl(*wall)), tnp(tu(*wall)), rtol=1e-12, atol=1e-14)
    face = [args[0], args[1], torch.full_like(args[0], 0.2)]
    want = tic(face[0], face[1]) if hook else tu(*face)
    np.testing.assert_allclose(tnp(tl(*face)), tnp(want), rtol=1e-12, atol=1e-14)


def test_problem_data_matches_jax():
    """The elements and bases (p_test_enrich's enlarged test space), the
    wall and initial-face rows (velocity only without bc_pressure), the
    anchor curve, the sensors with noise and the zero-mean gauge's points,
    weights and exact slice means, in JAX's draw order; the test grid and
    the extras."""
    kw = dict(bc_pressure=False, inverse=True, sensor_noise=0.05, p_zero_mean_weight=2.0, p_test_enrich=1,
              t_start=0.25)
    jprob, tprob = build_both(**kw)
    for key in ("elements", "basis_x", "basis_y", "basis_t"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), **F64, err_msg=f.name)
    assert sorted(tprob.data) == sorted(jprob.data) == sorted(
        ["basis_t", "basis_x", "basis_y", "elements", "p_anchor", "p_mean_exact", "ub", "us", "w_zeromean",
         "x_anchor", "x_zeromean", "xb", "xs"])
    assert tuple(tprob.data["ub"].shape) == (25, 2) and tuple(tprob.data["x_zeromean"].shape) == (3 * 256, 3)
    assert tuple(tprob.data["basis_x"].wphi.shape) == (3, 4)
    for key in ("xb", "xs", "x_anchor", "x_zeromean"):
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]), err_msg=key)
    for key in ("ub", "us", "p_anchor", "w_zeromean", "p_mean_exact"):
        np.testing.assert_allclose(tnp(tprob.data[key]), np.asarray(jprob.data[key]), **F64, err_msg=key)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, **F64)
    assert sorted(tprob.extras) == sorted(jprob.extras)
    for key in ("test_grid_shape", "component_names", "nu_true"):
        assert tprob.extras[key] == jprob.extras[key], key
    params = tprob.init_params(torch.Generator().manual_seed(0))
    assert params["pde"]["nu"].dim() == 0 and params["pde"]["nu"].item() == 0.3
    with pytest.raises(NotImplementedError, match="item 16"):
        tprob.extras["enriched_residual_fn"](params)
    with pytest.raises(ValueError, match="per-element test orders"):
        ttg.build(configs(p_test_enrich=1, n_test_x_per_elem=(2, 2))[1], device="cpu")
    with pytest.raises(ValueError, match="hard_bc requires bc_pressure=True"):
        ttg.build(configs(hard_bc=True, bc_pressure=False)[1], device="cpu")
    assert tv.build(tv.TaylorGreenConfig(**TINY), device="cpu").name == "taylorgreen"


def test_time_march_hooks_raise_like_jax():
    """The three ValueErrors of the ic_fn / ic_lift_fns hooks, with JAX's
    messages."""
    ic = lambda xy: np.zeros((len(xy), 3))  # noqa: E731
    for kw, hooks, match in (
        (dict(hard_bc=True), (ic,), "a handed-off ic_fn needs the matching"),
        ({}, (None, _ic_pair()[:1] * 2), "ic_lift_fns is a hard-BC lift hook"),
        (dict(inverse=True), (ic,), "ic_fn marches the FORWARD problem"),
    ):
        jcfg, tcfg = configs(**kw)
        for build, cfg in ((lambda c, *h: jtg.build(c, None, *h), jcfg),
                           (lambda c, *h: ttg.build(c, None, *h, device="cpu"), tcfg)):
            with pytest.raises(ValueError, match=match):
                build(cfg, *hooks)


def test_time_march_hooks_match_jax():
    """A slab [0.25, 1] with a handed-off initial face: ic_fn's values in
    ub and, under hard BC, the ic_lift_fns pair in the ansatz; the loss and
    gradients to rtol 1e-10."""
    def ic_fn(xy):
        return np.stack([0.9 * np.sin(xy[:, 0]), np.cos(xy[:, 1]), 0.1 * xy[:, 0]], axis=-1)

    (tu, ju), (tv_, jv_) = _ic_pair(), ((lambda x, y: 0.5 * torch.cos(x)), (lambda x, y: 0.5 * jnp.cos(x)))
    jprob, tprob = build_both((ic_fn, (ju, jv_)), (ic_fn, (tu, tv_)), hard_bc=True, t_start=0.25)
    np.testing.assert_allclose(tnp(tprob.data["ub"])[20:], ic_fn(tnp(tprob.data["xb"])[20:, :2]), **F64)
    np.testing.assert_allclose(tnp(tprob.data["ub"]), np.asarray(jprob.data["ub"]), **F64)
    compare_loss_and_grads(jprob, tprob, tight=LOSS)


# every option of the family, alone and together
CASES = {
    "form1": {},
    "form0": {"var_form": 0},
    "hard_bc_form0_zero_mean": {"hard_bc": True, "var_form": 0, "p_zero_mean_weight": 10.0},
    "hard_bc_form1": {"hard_bc": True},
    "no_bc_pressure": {"bc_pressure": False},
    "inverse": {"inverse": True, "sensor_noise": 0.05},
    "eq_weights_form0": {"eq_weights": (1.0, 3.0, 0.5), "var_form": 0},
    "p_test_enrich": {"p_test_enrich": 1},
    "all_soft_options": {"bc_pressure": False, "inverse": True, "eq_weights": (0.5, 2.0, 1.5),
                         "p_zero_mean_weight": 3.0, "p_test_enrich": 1},
}


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    jprob, tprob = build_both(**CASES[case])
    return jax_loss_and_grads(jprob, to_jax(shared_params(tprob)))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_gradients_match_jax(case):
    """Loss, every aux key (lossa, lossz, losss and nu where they apply) and
    every gradient, nu's included, to rtol 1e-10."""
    _, tprob = build_both(**CASES[case])
    compare_loss_and_grads(None, tprob, tight=LOSS, jax_out=jax_reference(case))


@pytest.mark.parametrize("case", ["form1", "hard_bc_form0_zero_mean", "all_soft_options"])
def test_gn_residual_vector_and_primal_jacobian_match_jax(case):
    """sum(r^2) is the loss (the anchor curve, the sensors and the zero-mean
    gauge in the residual vector; eq_weights and the p_test_enrich mask in
    the weak block), and r and the primal (M > P, forward-mode) J equal
    JAX's column for column."""
    s = System(*build_both(**CASES[case]))
    assert s.M > s.P
    r, J = s.trJ
    loss = s.tprob.loss_fn(s.tparams, s.tprob.data)[0]
    np.testing.assert_allclose(tnp(torch.sum(r * r)), tnp(loss), rtol=1e-12)
    jr, jJ = (np.asarray(a) for a in s.jrJ)
    np.testing.assert_allclose(tnp(r), jr, rtol=1e-10, atol=1e-13 * np.abs(jr).max())
    np.testing.assert_allclose(tnp(J), jJ, rtol=1e-10, atol=1e-13 * np.abs(jJ).max())


def test_three_lm_steps_match_jax():
    """Three accepted QR-LM steps with hard BC and the zero-mean gauge (form
    1: JAX's forward-mode Jacobian of form 0 compiles for half a minute on
    the CPU; form 0's J is held above) from the same params: counts, every
    record and the params to rtol 1e-8."""
    jprob, tprob = build_both(hard_bc=True, p_zero_mean_weight=10.0)
    tree = shared_params(tprob)
    kw = dict(iterations=3, solve="qr", verbose=False)
    jres = jgn.gauss_newton(jprob, to_jax(tree), **kw)
    tres = tv.gauss_newton(tprob, tv.params_from_jax(tree, dtype=torch.float64), **kw)
    assert (tres.accepted, tres.iterations_run, tres.stopped) == (jres.accepted, jres.iterations_run, jres.stopped)
    assert tres.accepted == 3 and sorted(tres.history) == sorted(jres.history)
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    for a, b in zip(jax.tree.leaves(jres.params), parameters(tres.params)):
        np.testing.assert_allclose(tnp(b), np.asarray(a), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("case", ["form1", "all_soft_options"])
def test_evaluation_matches_jax(case):
    """evaluate (rel_l2 and rel_l2_u/_v/_p), the strong residual [P, 3]
    (nu the leaf when inverse) and per_element_rel_l2."""
    jprob, tprob = build_both(**CASES[case])
    tree = shared_params(tprob)
    tparams, jparams = tv.params_from_jax(tree, dtype=torch.float64), to_jax(tree)
    got, want = tv.evaluate_problem(tprob, tparams), jv.evaluate_problem(jprob, jparams)
    assert sorted(got) == sorted(want) == ["max_abs_err", "mean_abs_err", "rel_l2", "rel_l2_p", "rel_l2_u", "rel_l2_v"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)
    X = np.random.default_rng(5).uniform(0.0, 1.0, (20, 3))
    sr = tv.strong_residual(tprob, tparams, X)
    assert sr.shape == (20, 3)
    np.testing.assert_allclose(sr, np.asarray(jevaluate.strong_residual(jprob, jparams, X)), rtol=1e-11, atol=1e-10)
    pe = tv.per_element_rel_l2(tprob, tparams, n_points=5)
    assert pe.shape == (8,)
    np.testing.assert_allclose(pe, jevaluate.per_element_rel_l2(jprob, jparams, n_points=5), rtol=1e-10)


def test_training_matches_jax():
    """8 Adam steps with every soft option: every record, lossa, lossz,
    losss and nu among them, to rtol 1e-8."""
    train = dict(iterations=8, check_every=4)
    jprob, tprob = build_both(train=train, **CASES["all_soft_options"])
    tree = shared_params(tprob)
    jres = jv.train(jprob, params=to_jax(tree), verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(tree, dtype=torch.float64), verbose=False)
    assert sorted(tres.history) == sorted(jres.history)
    assert {"lossa", "lossz", "losss", "nu"} <= set(tres.history)
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
