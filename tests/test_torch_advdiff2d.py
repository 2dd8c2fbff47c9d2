"""Port parity, AdvDiff-2D identification: the forcing, the training data
(walls, t = 0 face, sensors with noise), the element arrays and the test
grid, the loss, aux and gradients (eps and the velocity vector included) in
forms 0/1, forward runs with a true eps(x, y) map, the strong residual and a
short training run, against the JAX package on the CPU at a tiny size (one
element on a non-uniform x-grid of two, 4 quadrature points, 3^3 test
functions, a (3,6,6,1) tanh net), from the same numpy parameters.

Tolerances as in tests/test_torch_poisson3d.py: host arrays to 1e-12, f64
loss, aux and gradients against JAX "taylor" and "jvp" to rtol 1e-12, the
port's "pallas" on the CPU against JAX "taylor" to 1e-10, and in float32
against JAX "pallas" (interpret mode) the loss at rtol 1e-6 and each
gradient leaf at 2e-4 of its largest entry.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import evaluate as jevaluate  # noqa: E402
from hpvpinns_tpu.problems import advdiff2d as jad2  # noqa: E402
from hpvpinns_tpu_torch.problems import advdiff2d as tad2  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import (  # noqa: E402
    compare_loss_and_grads, jax_loss_and_grads, named_leaves, shared_params, tnp, to_jax, train_gn_tail,
)

TINY = dict(grid_x=(-1.0, 0.2, 1.0), n_quad=4, n_test_x=3, n_test_y=3, n_test_t=3, layers=(3, 6, 6, 1),
            n_bound=6, n_sensors_per_station=3, t_final=0.5, dtype="float64")
F64 = dict(rtol=1e-12, atol=1e-14)


def epsilon_map(x, y):
    """A true diffusivity map eps(x, y) in generic operations (numpy and torch)."""
    return 0.03 + 0.01 * x - 0.005 * y + 0.02 * x * y


def configs(**kw):
    kw = {**TINY, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return (jv.AdvDiff2DConfig(**kw, train=jv.TrainConfig(**tkw)),
            tv.AdvDiff2DConfig(**kw, train=tv.TrainConfig(**tkw)))


def build_both(epsilon_fn=None, **kw):
    jcfg, tcfg = configs(**kw)
    return jad2.build(jcfg, None, epsilon_fn), tad2.build(tcfg, None, epsilon_fn, device="cpu")


def test_presets_match_jax_fields():
    for name in ("advdiff2d_precision", "AdvDiff2DConfig"):
        assert dataclasses.asdict(getattr(tv, name)()) == dataclasses.asdict(getattr(jv, name)()), name
    train_gn_tail(tv.build(dataclasses.replace(tv.advdiff2d_precision(), **TINY), device="cpu"))


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_forcing_and_training_data_match_jax(noise):
    jcfg, tcfg = configs(sensor_noise_std=noise)
    jX, ju = jad2.training_data(jcfg, np.random.default_rng(3))
    tX, tu = tad2.training_data(tcfg, np.random.default_rng(3))
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tu, ju)
    assert tX.shape == (5 * 6 + 5 * 3, 3)
    if noise:  # the sensor locations do not move with the noise
        np.testing.assert_array_equal(tX, tad2.training_data(configs()[1], np.random.default_rng(3))[0])
    rng = np.random.default_rng(0)
    X, Y, T = rng.uniform(-1, 1, (3, 4, 5))
    for eps_fn in (None, epsilon_map):
        np.testing.assert_array_equal(tad2.make_forcing(tcfg, eps_fn)(X, Y, T),
                                      jad2.make_forcing(jcfg, eps_fn)(X, Y, T))


def test_problem_data_matches_jax():
    jprob, tprob = build_both(n_test_t_per_elem=(2,), velocity_trainable=True)
    for key in ("elements", "basis_x", "basis_y", "basis_t"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), **F64, err_msg=f.name)
    np.testing.assert_array_equal(tnp(tprob.data["xb"]), np.asarray(jprob.data["xb"]))
    np.testing.assert_allclose(tnp(tprob.data["ub"]), np.asarray(jprob.data["ub"]), **F64)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, **F64)
    assert tprob.extras["mesh"].shape == (2, 1, 1) and tprob.extras["test_grid_shape"] == (33, 33, 11)
    assert sorted(tprob.extras) == sorted(jprob.extras)
    for k in ("eps_true", "velocity_true"):
        assert tprob.extras[k] == jprob.extras[k]
    params = tprob.init_params(torch.Generator().manual_seed(0))
    assert params["pde"]["epsilon"].dim() == 0 and tuple(params["pde"]["velocity"].shape) == (2,)
    assert tprob.extras["eps_domain_mean"](params) == 1.0
    res = tprob.extras["enriched_residual_fn"](params)  # enrich 2 by default; parity in test_torch_adaptive.py
    assert res.shape[0] == 2 and res.dim() == 4 and bool(torch.isfinite(res).all())


CASES = {
    "form0": {"var_form": 0},
    "form1": {"var_form": 1},
    "form0_velocity": {"var_form": 0, "velocity_trainable": True},
    "form1_velocity": {"var_form": 1, "velocity_trainable": True},
    "form0_jvp": {"var_form": 0, "velocity_trainable": True, "deriv_mode": "jvp"},
    "form1_jvp": {"var_form": 1, "deriv_mode": "jvp"},
    "forward": {"inverse": False},
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_gradients_match_jax(case):
    jprob, tprob = build_both(**CASES[case])
    compare_loss_and_grads(jprob, tprob, tight=F64)


@pytest.mark.parametrize("var_form", [0, 1])
def test_forward_with_an_epsilon_map_matches_jax(var_form):
    """inverse=False with a true eps(x, y): the map and its derivatives (the
    JVP engine here, jax.jvp there) inside the weak form."""
    jprob, tprob = build_both(epsilon_map, inverse=False, var_form=var_form)
    assert tprob.extras["eps_true"] == pytest.approx(jprob.extras["eps_true"], rel=1e-14)
    compare_loss_and_grads(jprob, tprob, tight=F64)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_on_the_cpu_is_taylor(var_form):
    jprob, _ = build_both(var_form=var_form, velocity_trainable=True)
    _, tprob = build_both(var_form=var_form, velocity_trainable=True, deriv_mode="pallas")
    compare_loss_and_grads(jprob, tprob)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_f32_matches_jax_pallas(var_form):
    """float32 under "pallas" with a trainable velocity: loss, every aux key
    and every gradient, eps's and the velocity's included, against the JAX
    kernels in interpret mode."""
    jprob, tprob = build_both(var_form=var_form, velocity_trainable=True, deriv_mode="pallas", dtype="float32")
    tree = jax.tree.map(lambda a: a.astype(np.float32), shared_params(tprob))
    tparams = tv.params_from_jax(tree, dtype=torch.float32)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_loss_and_grads(jprob, to_jax(tree))
    assert sorted(taux) == sorted(jaux) == ["epsilon", "loss", "lossb", "lossv", "velocity", "vx", "vy"]
    for k in taux:
        np.testing.assert_allclose(tnp(taux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)
    names = [n for n, _ in named_leaves(jgrads)]
    assert names[-2:] == ["pde.epsilon", "pde.velocity"]
    for (name, j), t in zip(named_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(tnp(t), j, rtol=0, atol=2e-4 * np.abs(j).max(), err_msg=name)


@pytest.mark.parametrize("case", ["velocity", "forward_map"])
def test_strong_residual_matches_jax(case):
    kw, eps_fn = ({"velocity_trainable": True}, None) if case == "velocity" else ({"inverse": False}, epsilon_map)
    jprob, tprob = build_both(eps_fn, **kw)
    tree = shared_params(tprob)
    X = np.random.default_rng(5).uniform(0, 0.5, (20, 3)) * np.array([2, 2, 1]) - np.array([0.5, 0.5, 0])
    got = tv.strong_residual(tprob, tv.params_from_jax(tree, dtype=torch.float64), X)
    want = jevaluate.strong_residual(jprob, to_jax(tree), X)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-11, atol=1e-12)


def test_training_matches_jax():
    """8 Adam steps under "pallas" (the plain versions on the CPU) with a
    trainable velocity against JAX "taylor": every record, eps and |V|
    among them, to rtol 1e-8, and evaluate() on the test grid."""
    train = dict(iterations=8, check_every=4)
    jprob, _ = build_both(var_form=0, velocity_trainable=True, train=train)
    _, tprob = build_both(var_form=0, velocity_trainable=True, deriv_mode="pallas", train=train)
    tree = shared_params(tprob)
    jres = jv.train(jprob, params=to_jax(tree), verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(tree, dtype=torch.float64), verbose=False)
    assert sorted(tres.history) == sorted(jres.history)
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    want, got = jv.evaluate_problem(jprob, jres.params), tv.evaluate_problem(tprob, tres.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
