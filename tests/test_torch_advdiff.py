"""Port parity, AdvDiff identification: the problem's data, its loss, aux
and gradients in every form and coefficient model of the PyTorch port
against the JAX package, on the CPU, at the small size of
tests/test_torch_parity.py, from the same numpy parameters (the port's init with
random biases) given to both packages, through `convert` to the port.
tests/test_torch_advdiff_train.py holds the trainer, tests/test_torch_hard_bc.py
the hard-BC and input-feature ansatzes.

Tolerances: host arrays bit for bit or to 1e-12 (the same numpy code);
loss, every aux key and the gradient of every net and PDE leaf rtol 1e-10
in float64 (the same f64 arithmetic in another order).  The port's "pallas" on the CPU is the plain Taylor propagation, held
to JAX "taylor" in float64; against JAX "pallas" (interpret mode on the
CPU, float32) the loss at rtol 1e-6 and each gradient leaf at 2e-4 of its
largest entry, as tests/test_torch_poisson2d.py holds the f32 kernels.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.problems import advdiff as jad  # noqa: E402
from hpvpinns_tpu_torch.problems import advdiff as tad  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import (  # noqa: E402
    ADV,
    compare_loss_and_grads,
    epsilon_field,
    jax_loss_and_grads,
    named_leaves,
    shared_params,
    tnp,
    to_jax,
    train_gn_tail,
    velocity_field,
)


def configs(**kw):
    kw = {**ADV, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return (jv.AdvDiffConfig(**kw, train=jv.TrainConfig(**tkw)),
            tv.AdvDiffConfig(**kw, train=tv.TrainConfig(**tkw)))


def test_presets_match_jax_fields():
    for name in ("advdiff_of_record", "advdiff_quality", "advdiff_precision", "advdiff_forward_precision"):
        t, j = getattr(tv, name)(), getattr(jv, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    assert dataclasses.asdict(tv.AdvDiffConfig()) == dataclasses.asdict(jv.AdvDiffConfig())
    for name in ("advdiff_precision", "advdiff_forward_precision"):  # their Gauss-Newton tails run
        train_gn_tail(tv.build(dataclasses.replace(getattr(tv, name)(), **ADV), device="cpu"))


def test_u_exact_matches_jax():
    """The 800-term series on a few points, and a short series on more points
    than one chunk of the port's evaluation."""
    rng = np.random.default_rng(0)
    x, t = rng.uniform(-1, 1, (7, 1)), np.concatenate([[[0.0]], rng.uniform(0, 1, (6, 1))])
    eps = 0.1 / np.pi
    np.testing.assert_allclose(tad.u_exact(x, t, eps, 1.0), jad.u_exact(x, t, eps, 1.0), rtol=1e-12, atol=1e-15)
    n = tad._SERIES_ROWS + 1000
    x, t = rng.uniform(-1, 1, (n, 1)), rng.uniform(0, 1, (n, 1))
    np.testing.assert_allclose(tad.u_exact(x, t, eps, 1.0, trunc=20), jad.u_exact(x, t, eps, 1.0, trunc=20),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_training_data_matches_jax(noise):
    jcfg, tcfg = configs(sensor_noise_std=noise)
    jX, ju = jad.training_data(jcfg, np.random.default_rng(3))
    tX, tu = tad.training_data(tcfg, np.random.default_rng(3))
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_allclose(tu, ju, rtol=1e-12, atol=1e-15)
    assert tX.shape == (3 * 10 + 15, 2)
    if noise:  # the sensor locations do not move with the noise
        np.testing.assert_array_equal(tX, tad.training_data(configs()[1], np.random.default_rng(3))[0])


def test_problem_data_matches_jax():
    jcfg, tcfg = configs(n_elements_x=2, n_test_t_per_elem=(4,))
    jprob, tprob = jv.build(jcfg), tv.build(tcfg, device="cpu")
    for key in ("elements", "basis_x", "basis_t"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), rtol=1e-13, atol=1e-14)
    for key in ("xb", "ub"):
        np.testing.assert_allclose(tnp(tprob.data[key]), np.asarray(jprob.data[key]), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, rtol=1e-12, atol=1e-15)
    assert sorted(tprob.extras) == sorted(jprob.extras)
    assert tprob.extras["eps_true"] == jprob.extras["eps_true"] and tprob.extras["test_grid_shape"] == (31, 256)


CASES = {  # id: (config overrides, build's keyword arguments); the hard-BC and
    # input-feature ansatzes are in tests/test_torch_fields_jvp.py
    "form0": ({}, {}),
    "form1": ({"var_form": 1}, {}),
    "form2": ({"var_form": 2}, {}),
    "form0_quadratic_reg": ({"epsilon_model": "quadratic", "epsilon_reg": 1e-2}, {}),
    "form1_quadratic_reg": ({"var_form": 1, "epsilon_model": "quadratic", "epsilon_reg": 1e-2}, {}),
    "form0_mlp": ({"epsilon_model": "mlp"}, {}),
    "form1_mlp_reg": ({"var_form": 1, "epsilon_model": "mlp", "epsilon_reg": 1e-3}, {}),
    "form0velocity_fieldocity_linear": ({"velocity_trainable": True, "velocity_model": "linear"}, {}),
    "form1velocity_fieldocity_quadratic": ({"var_form": 1, "velocity_trainable": True, "velocity_model": "quadratic"}, {}),
    "form2velocity_fieldocity_scalar": ({"var_form": 2, "velocity_trainable": True}, {}),
    "forward": ({"inverse": False}, {}),
    "time_slab": ({"t_start": 0.1}, {"ic_fn": lambda x: -np.sin(np.pi * x) * 0.9}),
    "cos_forward": ({"inverse": False, "var_form": 1}, {"manufactured": True}),
    "cos_quadratic": ({"epsilon_model": "quadratic", "velocity_trainable": True, "velocity_model": "linear"},
                      {"manufactured": True}),
}


def build_both(case_kw, build_kw, deriv_mode="taylor"):
    jcfg, tcfg = configs(deriv_mode=deriv_mode, **case_kw)
    kw = dict(build_kw)
    if kw.pop("manufactured", False):
        u_fn, f_fn = tad.make_manufactured(tcfg, velocity_field, epsilon=epsilon_field, profile="cos")
        ju, jf = jad.make_manufactured(jcfg, velocity_field, epsilon=epsilon_field, profile="cos")
        np.testing.assert_array_equal(f_fn(np.ones((2, 1)) * 0.3, np.ones((2, 1))), jf(np.ones((2, 1)) * 0.3, np.ones((2, 1))))
        kw = dict(kw, u_fn=u_fn, f_fn=f_fn, velocity_fn=velocity_field, epsilon_fn=epsilon_field)
        jkw = dict(kw, u_fn=ju, f_fn=jf)
    else:
        jkw = kw
    return jad.build(jcfg, **jkw), tad.build(tcfg, **kw, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_gradients_match_jax(case):
    jprob, tprob = build_both(*CASES[case])
    compare_loss_and_grads(jprob, tprob)
    if case in ("cos_forward", "cos_quadratic"):
        assert tprob.extras["eps_true"] == pytest.approx(jprob.extras["eps_true"], rel=1e-14)
        assert tprob.extras["velocity_true"] == pytest.approx(jprob.extras["velocity_true"], rel=1e-14)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_on_the_cpu_is_taylor(var_form):
    """The port's "pallas" on a CPU tensor runs the kernels' plain versions:
    JAX "taylor" in float64."""
    jprob, _ = build_both({"var_form": var_form, "epsilon_model": "quadratic"}, {})
    _, tprob = build_both({"var_form": var_form, "epsilon_model": "quadratic"}, {}, deriv_mode="pallas")
    compare_loss_and_grads(jprob, tprob)


def test_pallas_f32_matches_jax_pallas():
    """var_form 0 under "pallas" in float32: the port's plain versions against
    the JAX kernels (interpret mode), loss and every gradient, eps included."""
    jcfg, tcfg = configs(deriv_mode="pallas", dtype="float32")
    jprob, tprob = jv.build(jcfg), tv.build(tcfg, device="cpu")
    tree = jax.tree.map(lambda a: a.astype(np.float32), shared_params(tprob))
    jparams = to_jax(tree)
    tparams = tv.params_from_jax(tree, dtype=torch.float32)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_loss_and_grads(jprob, jparams)
    np.testing.assert_allclose(tnp(tloss), float(jaux["loss"]), rtol=1e-6)
    np.testing.assert_allclose(tnp(taux["epsilon"]), float(jaux["epsilon"]), rtol=0)
    for (name, j), t in zip(named_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(tnp(t), j, rtol=0, atol=2e-4 * np.abs(j).max(), err_msg=name)
    assert named_leaves(jgrads)[-1][0] == "pde.epsilon"


def test_hard_bc_holds_exactly_for_random_parameters():
    """u = g + D N: u(+-1, t) = 0 and u(x, 0) = -sin(pi x) for any network."""
    _, tcfg = configs(hard_bc=True)
    prob = tv.build(tcfg, device="cpu")
    params = prob.init_params(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for layer in params["net"]:
            layer["b"].normal_(generator=torch.Generator().manual_seed(6))
    t = torch.linspace(0, 0.3, 17, dtype=torch.float64)[:, None]
    x = torch.linspace(-1, 1, 17, dtype=torch.float64)[:, None]
    with torch.no_grad():
        for X in (torch.cat([torch.ones_like(t), t], 1), torch.cat([-torch.ones_like(t), t], 1)):
            np.testing.assert_array_equal(tnp(prob.apply(params, X)), tnp(-torch.sin(np.pi * X[:, :1])))
        u0 = prob.apply(params, torch.cat([x, torch.zeros_like(x)], 1))
        np.testing.assert_array_equal(tnp(u0), tnp(-torch.sin(np.pi * x)))


def test_build_errors_match_jax():
    _, tcfg = configs(layer_feature=True)
    with pytest.raises(ValueError, match="layer_feature"):
        tv.build(tcfg, device="cpu")
    for bad, match in (({"epsilon_model": "cubic"}, "epsilon_model"), ({"velocity_model": "cubic"}, "velocity_model"),
                       ({"deriv_mode": "autodiff"}, "deriv_mode")):
        with pytest.raises(ValueError, match=match):
            tv.build(configs(**bad)[1], device="cpu")
    with pytest.raises(ValueError, match="soft BC"):
        tv.build(configs(hard_bc=True, t_start=0.1)[1], device="cpu")
    with pytest.raises(ValueError, match="lift_fn"):
        tad.build(configs(hard_bc=True)[1], None, None, None, lambda x, t: 0 * x, device="cpu")
    prob = tv.build(configs(epsilon_model="quadratic", var_form=2)[1], device="cpu")
    with pytest.raises(ValueError, match="scalar epsilon"):
        prob.loss_fn(prob.init_params(torch.Generator().manual_seed(0)), prob.data)
    with pytest.raises(ValueError, match="scalar epsilon"):  # the enriched residual shares the weak form
        prob.extras["enriched_residual_fn"](prob.init_params(torch.Generator().manual_seed(0)))
