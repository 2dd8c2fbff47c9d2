"""Port parity, Kovasznay (the steady Navier-Stokes system): the vector JVP
engine in 2D, the NS weak residual in forms 0/1, the exact solution, its
torch twin and the Coons lift, the built data (boundary rows, the pressure
anchor, the sensors with noise), the loss, aux and gradients in every option
(soft and hard BC, bc_pressure=False, inverse with nu a leaf, eq_weights),
the Gauss-Newton residual vector and its Jacobian, three LM steps, evaluate's
component keys, the strong residual, per_element_rel_l2 (of every ported
family) and a short training run, against the JAX package on the CPU in
float64 at a tiny size (a 2x2 mesh, 5 quadrature points, 3 x 3 test
functions, a (2,8,8,3) tanh net), from the same numpy parameters.

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
from hpvpinns_tpu.problems import kovasznay as jkov  # noqa: E402
from hpvpinns_tpu_torch.ops import assembly as tasm  # noqa: E402
from hpvpinns_tpu_torch.ops import fields as tfields  # noqa: E402
from hpvpinns_tpu_torch.problems import kovasznay as tkov  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_gauss_newton import System  # noqa: E402
from test_torch_parity import (  # noqa: E402
    ADV, compare_loss_and_grads, jax_loss_and_grads, mlp_pair, one_torch_thread, shared_params, tnp, to_jax,
    train_gn_tail,
)

jgn = importlib.import_module("hpvpinns_tpu.training.gauss_newton")

TINY = dict(layers=(2, 8, 8, 3), n_quad=5, n_test_x=3, n_test_y=3, n_bound=5, n_sensors=6, dtype="float64")
F64 = dict(rtol=1e-12, atol=1e-14)
LOSS = dict(rtol=1e-10, atol=1e-13)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def configs(**kw):
    kw = {**TINY, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return jv.KovasznayConfig(**kw, train=jv.TrainConfig(**tkw)), tv.KovasznayConfig(**kw, train=tv.TrainConfig(**tkw))


def build_both(**kw):
    jcfg, tcfg = configs(**kw)
    return jkov.build(jcfg), tkov.build(tcfg, device="cpu")


def test_presets_match_jax_fields():
    """The config and both presets field for field (deriv_mode "jvp"); the
    precision preset's LM phase runs in train at a tiny size."""
    for name in ("KovasznayConfig", "kovasznay_quality", "kovasznay_precision"):
        assert dataclasses.asdict(getattr(tv, name)()) == dataclasses.asdict(getattr(jv, name)()), name
    assert tv.KovasznayConfig().deriv_mode == "jvp"
    train_gn_tail(tv.build(dataclasses.replace(tv.kovasznay_precision(), **dict(TINY, layers=(2, 6, 6, 3))),
                           device="cpu"))


@pytest.mark.parametrize("firsts_only", [False, True])
def test_vector_fields_2d_match_jax(firsts_only):
    """Every key and component of the 2D vector engine at [E, Qy, Qx]
    points, to 1e-12."""
    tfn, jfn = mlp_pair((2, 7, 7, 3))
    x, y = np.random.default_rng(1).uniform(-1, 1, (2, 3, 4, 5))
    got = tfields.vector_fields_2d(tfn, torch.tensor(x), torch.tensor(y), firsts_only=firsts_only)
    want = jfields.vector_fields_2d(jfn, jnp.asarray(x), jnp.asarray(y), firsts_only=firsts_only)
    assert sorted(got) == sorted(want) == (["w", "wx", "wy"] if firsts_only else ["w", "wx", "wxx", "wy", "wyy"])
    for k in want:
        assert tuple(got[k].shape) == want[k].shape == (3, 4, 5, 3)
        np.testing.assert_allclose(tnp(got[k]), np.asarray(want[k]), **F64, err_msg=k)


@pytest.mark.parametrize("var_form", [0, 1])
def test_ns_residual_matches_jax(var_form):
    """[E, 3, K, R] on a non-uniform mesh, nu a number, to 1e-12; any other
    form raises JAX's ValueError."""
    jprob, tprob = build_both(grid_x=(-0.5, 0.1, 1.0), n_test_x=4)
    tfn, jfn = mlp_pair((2, 7, 7, 3))
    got = tasm.ns_residual(tfn, tprob.data["elements"], tprob.data["basis_x"], tprob.data["basis_y"], var_form, 0.025)
    want = jasm.ns_residual(jfn, jprob.data["elements"], jprob.data["basis_x"], jprob.data["basis_y"], var_form,
                            0.025)
    assert tuple(got.shape) == want.shape == (4, 3, 3, 4)
    np.testing.assert_allclose(tnp(got), np.asarray(want), **F64)
    with pytest.raises(ValueError, match="Navier-Stokes var_form must be 0 or 1; got 2"):
        tasm.ns_residual(tfn, tprob.data["elements"], tprob.data["basis_x"], tprob.data["basis_y"], 2, 0.025)


def test_exact_solution_and_lift_match_jax():
    """The host solution, its torch twin and the Coons lift (the trace on
    every edge), the hard-BC envelope through the composite ansatz."""
    x, y = np.random.default_rng(2).uniform(-0.5, 1.5, (2, 9, 1))
    assert tkov.lam_of(40.0) == jkov.lam_of(40.0)
    np.testing.assert_array_equal(tkov.exact_stacked(x, y.T, 40.0), jkov.exact_stacked(x, y.T, 40.0))
    tu, tvv = tkov.exact_uv(40.0)
    ju, jvv = jkov.exact_uv_jnp(40.0)
    xt, yt = torch.tensor(x), torch.tensor(y)
    for t, j in ((tu, ju), (tvv, jvv)):
        np.testing.assert_allclose(tnp(t(xt, yt)), np.asarray(j(jnp.asarray(x), jnp.asarray(y))), **F64)
        tl = tkov.coons_lift(t, (-0.5, 1.0), (-0.5, 1.5))
        jl = jkov.coons_lift_jnp(j, (-0.5, 1.0), (-0.5, 1.5))
        np.testing.assert_allclose(tnp(tl(xt, yt)), np.asarray(jl(jnp.asarray(x), jnp.asarray(y))), **F64)
        ex = torch.tensor([[-0.5], [1.0], [0.3], [-0.1]], dtype=torch.float64)
        ey = torch.tensor([[0.7], [-0.2], [-0.5], [1.5]], dtype=torch.float64)
        np.testing.assert_allclose(tnp(tl(ex, ey)), tnp(t(ex, ey)), **F64)
    jprob, tprob = build_both(hard_bc=True)
    tree = shared_params(tprob)
    X = np.hstack([x, y])
    np.testing.assert_allclose(tnp(tprob.apply(tv.params_from_jax(tree, dtype=torch.float64), torch.tensor(X))),
                               np.asarray(jprob.apply(to_jax(tree), jnp.asarray(X))), **F64)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_problem_data_matches_jax(noise):
    """The elements and bases, the boundary rows (velocity only without
    bc_pressure), the pressure anchor, the sensors and their noisy readings
    in JAX's draw order, the test grid and the extras."""
    jprob, tprob = build_both(bc_pressure=False, inverse=True, sensor_noise=noise, n_test_x_per_elem=(3, 2))
    for key in ("elements", "basis_x", "basis_y"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), **F64, err_msg=f.name)
    assert sorted(tprob.data) == sorted(jprob.data) == ["basis_x", "basis_y", "elements", "p_anchor", "ub", "us",
                                                        "x_anchor", "xb", "xs"]
    assert tuple(tprob.data["ub"].shape) == (20, 2)
    for key in ("xb", "xs", "x_anchor"):
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]), err_msg=key)
    for key in ("ub", "us", "p_anchor"):
        np.testing.assert_allclose(tnp(tprob.data[key]), np.asarray(jprob.data[key]), **F64, err_msg=key)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, **F64)
    assert sorted(tprob.extras) == sorted(jprob.extras)
    for key in ("test_grid_shape", "component_names", "nu_true"):
        assert tprob.extras[key] == jprob.extras[key], key
    params = tprob.init_params(torch.Generator().manual_seed(0))
    assert params["pde"]["nu"].dim() == 0 and float(params["pde"]["nu"]) == 0.1
    with pytest.raises(NotImplementedError, match="item 16"):
        tprob.extras["enriched_residual_fn"](params)
    with pytest.raises(ValueError, match="hard_bc requires bc_pressure=True"):
        tkov.build(configs(hard_bc=True, bc_pressure=False)[1], device="cpu")
    jb, tb = build_both()
    assert sorted(tb.data) == sorted(jb.data) == ["basis_x", "basis_y", "elements", "ub", "xb"]
    assert "reg_resvec_fn" not in tb.extras
    with pytest.raises(TypeError):
        tv.build(object(), device="cpu")
    assert tv.build(tv.KovasznayConfig(**TINY), device="cpu").name == "kovasznay"


# every option of the family, alone and together
CASES = {
    "form1": {},
    "form0": {"var_form": 0},
    "hard_bc_form1": {"hard_bc": True},
    "hard_bc_form0": {"hard_bc": True, "var_form": 0},
    "no_bc_pressure": {"bc_pressure": False},
    "inverse": {"inverse": True, "sensor_noise": 0.05},
    "eq_weights_form0": {"eq_weights": (1.0, 3.0, 0.5), "var_form": 0},
    "all_soft_options": {"bc_pressure": False, "inverse": True, "eq_weights": (0.5, 2.0, 1.5)},
    "hard_bc_inverse_eq_weights": {"hard_bc": True, "inverse": True, "eq_weights": (1.0, 3.0, 1.0)},
}


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    jprob, tprob = build_both(**CASES[case])
    return jax_loss_and_grads(jprob, to_jax(shared_params(tprob)))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_gradients_match_jax(case):
    """Loss, every aux key (lossa, losss and nu where they apply) and every
    gradient, nu's included, to rtol 1e-10."""
    _, tprob = build_both(**CASES[case])
    compare_loss_and_grads(None, tprob, tight=LOSS, jax_out=jax_reference(case))


@pytest.mark.parametrize("case, dual", [("form1", False), ("hard_bc_form0", False), ("all_soft_options", False),
                                        ("hard_bc_inverse_eq_weights", False), ("all_soft_options", True)])
def test_gn_residual_vector_and_jacobian_match_jax(case, dual):
    """sum(r^2) is the loss (the partial-state ub rows, the anchor and the
    sensors in the residual vector; eq_weights inside the weak block), and
    r and J equal JAX's column for column: primal at the (2,8,8,3) net,
    dual (M < P) at (2,16,16,3)."""
    kw = dict(CASES[case], **({"layers": (2, 16, 16, 3)} if dual else {}))
    s = System(*build_both(**kw))
    assert (s.M < s.P) == dual
    r, J = s.trJ
    loss = s.tprob.loss_fn(s.tparams, s.tprob.data)[0]
    np.testing.assert_allclose(tnp(torch.sum(r * r)), tnp(loss), rtol=1e-12)
    jr, jJ = (np.asarray(a) for a in s.jrJ)
    np.testing.assert_allclose(tnp(r), jr, rtol=1e-10, atol=1e-13 * np.abs(jr).max())
    np.testing.assert_allclose(tnp(J), jJ, rtol=1e-10, atol=1e-13 * np.abs(jJ).max())


def test_three_lm_steps_match_jax():
    """Three accepted QR-LM steps (the precision preset's solve) under hard
    BC from the same params: counts, every record and the params to rtol
    1e-8."""
    jprob, tprob = build_both(**CASES["hard_bc_form1"])
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


@pytest.mark.parametrize("case", ["form1", "hard_bc_inverse_eq_weights"])
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
    X = np.random.default_rng(5).uniform(-0.5, 1.0, (20, 2))
    sr = tv.strong_residual(tprob, tparams, X)
    assert sr.shape == (20, 3)
    np.testing.assert_allclose(sr, np.asarray(jevaluate.strong_residual(jprob, jparams, X)), rtol=1e-11, atol=1e-10)
    pe = tv.per_element_rel_l2(tprob, tparams, n_points=7)
    assert pe.shape == (4,)
    np.testing.assert_allclose(pe, jevaluate.per_element_rel_l2(jprob, jparams, n_points=7), rtol=1e-10)


# per_element_rel_l2 of every family the port has: (JAX config, port config)
PER_ELEMENT = {
    "poisson1d": ("Poisson1DConfig", dict(layers=(1, 6, 1), grid=(-1.0, 0.0, 1.0), n_test=4, n_quad=8,
                                          dtype="float64")),
    "poisson2d": ("Poisson2DConfig", dict(n_elements_x=2, n_quad=5, n_test_x=3, n_test_y=3, layers=(2, 6, 1),
                                          dtype="float64")),
    "poisson3d": ("Poisson3DConfig", dict(n_elements_x=2, n_quad=4, n_test_x=2, n_test_y=2, n_test_z=2,
                                          layers=(3, 5, 1), n_bound=6, dtype="float64")),
    "helmholtz2d": ("Helmholtz2DConfig", dict(n_elements_x=2, n_quad=5, n_test_x=3, n_test_y=3, layers=(2, 6, 1),
                                              n_bound=6, dtype="float64")),
    "advdiff": ("AdvDiffConfig", dict(ADV, n_elements_x=2)),
    "advdiff2d": ("AdvDiff2DConfig", dict(n_elements_x=2, n_quad=4, n_test_x=2, n_test_y=2, n_test_t=2,
                                          layers=(3, 5, 1), n_bound=6, n_sensors_per_station=3, dtype="float64")),
    "burgers": ("BurgersConfig", dict(n_elements_x=2, n_elements_t=1, n_quad=5, n_test_x=3, n_test_t=3,
                                      layers=(2, 6, 1), n_bound=6, t_final=0.5, dtype="float64")),
    "taylorgreen": ("TaylorGreenConfig", dict(n_quad=4, n_test_x=2, n_test_y=2, n_test_t=2, layers=(3, 6, 3),
                                              n_bound=5, dtype="float64")),
}


@pytest.mark.parametrize("family", sorted(PER_ELEMENT))
def test_per_element_rel_l2_matches_jax(family):
    """per_element_rel_l2 at 6 points per axis, [E] in the mesh's flat
    order, to rtol 1e-10 (Kovasznay's is in test_evaluation_matches_jax)."""
    name, cfg = PER_ELEMENT[family]
    jprob, tprob = jv.build(getattr(jv, name)(**cfg)), tv.build(getattr(tv, name)(**cfg), device="cpu")
    tree = shared_params(tprob)
    got = tv.per_element_rel_l2(tprob, tv.params_from_jax(tree, dtype=torch.float64), n_points=6)
    want = jevaluate.per_element_rel_l2(jprob, to_jax(tree), n_points=6)
    assert got.shape == want.shape == (tprob.extras["mesh"].n_elem,)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_training_matches_jax():
    """8 Adam steps of the inverse run without boundary p: every record, nu
    and lossa among them, to rtol 1e-8."""
    train = dict(iterations=8, check_every=4)
    jprob, tprob = build_both(bc_pressure=False, inverse=True, train=train)
    tree = shared_params(tprob)
    jres = jv.train(jprob, params=to_jax(tree), verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(tree, dtype=torch.float64), verbose=False)
    assert sorted(tres.history) == sorted(jres.history)
    assert {"nu", "lossa", "losss"} <= set(tres.history)
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
