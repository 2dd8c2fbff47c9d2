"""Port parity, Poisson-1D: the problem, its weak forms 1/2/3 and the Adam
trainer of the PyTorch port against the JAX package, in float64 on the CPU,
at a small size (the reference's 3-element grid (-1, -0.1, 0.1, 1), 12
quadrature points, 5 test functions, a (1,8,8,1) sin net), from the same
JAX-initialised parameters whose zero biases are perturbed with numpy noise
(at zero biases the odd sin network makes some gradient entries cancel to
roundoff, and Adam turns roundoff into full-size steps).

Tolerances: data arrays rtol 1e-13; loss and gradients rtol 1e-10 against
JAX "taylor", with gradient entries that cancel held at 1e-10 of their
leaf's largest entry; 20 Adam steps rtol 1e-8.  The port's "pallas" mode on
the CPU is the plain Taylor propagation and, for its gradient, B2's plain
version.  Against JAX "pallas", whose Pallas kernels accumulate in float32:
the float64 loss at rtol 1e-6 (as tests/test_torch_poisson2d.py); the
gradients in float32, because the JAX backward kernel keeps its scratch in
float32 (pallas_fields.py:426-430) and refuses float64 values, at 2e-4 of
each leaf's largest entry for forms 1 and 2 (measured gaps 6.0e-7 and
7.9e-6) and 5e-3 for form 3, whose float32 gradient is ill-conditioned:
the port is 2.57e-3 of the leaf scale from JAX "pallas" there, and JAX's
own "taylor" and "pallas" gradients are 2.40e-3 apart.  The float64 checks
above are the main ones."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import option_matches_default  # noqa: E402

SMALL = dict(
    grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, n_quad=12, n_test=5,
    layers=(1, 8, 8, 1), dtype="float64",
)
TIGHT = dict(rtol=1e-10, atol=1e-13)
F32_GRAD_SCALE_TOL = {1: 2e-4, 2: 2e-4, 3: 5e-3}


def configs(deriv_mode="taylor", var_form=1, dtype="float64", **train):
    tcfg = tv.TrainConfig(iterations=20, check_every=10, **train)
    jcfg = jv.TrainConfig(iterations=20, check_every=10, **train)
    kw = dict(SMALL, var_form=var_form, deriv_mode=deriv_mode, dtype=dtype)
    return jv.Poisson1DConfig(**kw, train=jcfg), tv.Poisson1DConfig(**kw, train=tcfg)


@pytest.fixture(scope="module")
def jax_side():
    prob = jv.build(configs()[0])
    np_params = jax.tree.map(np.asarray, prob.init_params(jax.random.key(0)))
    rng = np.random.default_rng(7)
    for layer in np_params["net"]:
        layer["b"] = layer["b"] + 0.1 * rng.standard_normal(layer["b"].shape)
    return prob, jax.tree.map(jnp.asarray, np_params), np_params


def close_to_leaf_scale(got, want, scale_tol):
    """|got - want| <= scale_tol * max|want| over the leaf."""
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol * np.abs(want).max())


def jax_loss_and_grads(prob, params):
    (_, aux), grads = jax.jit(jax.value_and_grad(prob.loss_fn, has_aux=True))(params, prob.data)
    return aux, [np.asarray(a) for layer in grads["net"] for a in (layer["W"], layer["b"])]


@pytest.fixture(scope="module")
def jax_taylor(jax_side):
    """JAX "taylor" (aux, gradient leaves) for a var_form, computed once for
    both of the port's deriv modes."""
    _, jparams, _ = jax_side
    return functools.cache(lambda var_form: jax_loss_and_grads(jv.build(configs("taylor", var_form)[0]), jparams))


def tnp(t):
    return t.detach().cpu().numpy()


def test_problem_data_matches_jax(jax_side):
    jprob, _, _ = jax_side
    tprob = tv.build(configs()[1], device="cpu")
    for key in ("elements", "basis"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), rtol=1e-13, atol=1e-14)
    for key in ("xb", "ub"):
        assert tprob.data[key].shape == (2, 1)
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]))
    assert tprob.test_points.shape == (2001, 1)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_array_equal(tprob.test_values, jprob.test_values)
    np.testing.assert_array_equal(tprob.extras["mesh"].grid, jprob.extras["mesh"].grid)


@pytest.mark.parametrize("deriv_mode", ["taylor", "pallas"])
@pytest.mark.parametrize("var_form", [1, 2, 3])
def test_loss_and_gradients_match_jax(jax_side, jax_taylor, var_form, deriv_mode):
    _, jparams, np_params = jax_side
    jcfg, tcfg = configs(deriv_mode, var_form)
    tprob = tv.build(tcfg, device="cpu")
    tparams = tv.params_from_jax(np_params, dtype=torch.float64)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))

    jaux, jgrads = jax_taylor(var_form)
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(tnp(taux[k]), float(jaux[k]), **TIGHT, err_msg=k)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(tnp(t), j, rtol=1e-10, atol=1e-10 * np.abs(j).max())

    if deriv_mode == "pallas":  # the JAX kernels themselves, f32-accumulated
        jprob = jv.build(jcfg)
        np.testing.assert_allclose(tnp(tloss), float(jax.jit(jprob.loss_fn)(jparams, jprob.data)[0]), rtol=1e-6)
        jcfg32, tcfg32 = configs("pallas", var_form, dtype="float32")
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        _, jgrads32 = jax_loss_and_grads(jv.build(jcfg32), p32)
        tprob32 = tv.build(tcfg32, device="cpu")
        tparams32 = tv.params_from_jax(np_params, dtype=torch.float32)
        tgrads32 = torch.autograd.grad(tprob32.loss_fn(tparams32, tprob32.data)[0], parameters(tparams32))
        for t, j in zip(tgrads32, jgrads32):
            close_to_leaf_scale(tnp(t), j, F32_GRAD_SCALE_TOL[var_form])


@pytest.fixture(scope="module")
def jax_trained(jax_side):
    jprob, jparams, _ = jax_side
    return jv.train(jprob, params=jparams, verbose=False)


@pytest.mark.parametrize("deriv_mode", ["taylor", "pallas"])
def test_adam_history_and_evaluation_match_jax(jax_side, jax_trained, deriv_mode):
    jprob, _, np_params = jax_side
    tprob = tv.build(configs(deriv_mode)[1], device="cpu")
    res = tv.train(tprob, params=tv.params_from_jax(np_params, dtype=torch.float64), verbose=False)
    jres = jax_trained
    assert res.iterations_run == jres.iterations_run == 20
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(res.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    for t, j in zip(res.params["net"], jres.params["net"]):
        for name in ("W", "b"):
            np.testing.assert_allclose(tnp(t[name]), np.asarray(j[name]), rtol=1e-8, atol=1e-12)
    # predict/evaluate serve the 2,001-point 1-D test grid
    u = tv.predict(tprob, res.params)
    assert u.shape == (2001, 1)
    np.testing.assert_allclose(u, np.asarray(jv.predict(jprob, jres.params)), rtol=1e-8, atol=1e-12)
    tev = tv.evaluate_problem(tprob, res.params)
    jev = jv.evaluate_problem(jprob, jres.params)
    for k in ("rel_l2", "max_abs_err", "mean_abs_err"):
        np.testing.assert_allclose(tev[k], jev[k], rtol=1e-8, err_msg=k)


def test_presets_match_jax_fields():
    for name in ("poisson1d_of_record", "poisson1d_quality", "poisson1d_precision"):
        t, j = getattr(tv, name)(), getattr(jv, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    cfg = tv.poisson1d_of_record()
    assert cfg.layers == (1, 20, 20, 20, 20, 1) and cfg.n_quad == 80 and cfg.activation == "sin"


@pytest.mark.parametrize("cfg_kw", [{"adaptive_slope": True}, {"matmul_precision": "high"}])
def test_unported_options_raise(cfg_kw):
    """The adaptive slope and matmul precision "high" are ported: they build
    and match the default on the CPU at the initial state.  Under "pallas"
    the slope still raises, with the JAX package's ValueError, on the CPU
    too; "high" runs there (the kernels stay IEEE fp32)."""
    option_matches_default(configs()[1], **cfg_kw)
    prob = tv.build(dataclasses.replace(configs("pallas")[1], **cfg_kw), device="cpu")
    params = prob.init_params(torch.Generator().manual_seed(0))
    if cfg_kw.get("adaptive_slope"):
        with pytest.raises(ValueError, match="deriv_mode='pallas' does not support adaptive_slope; use 'taylor'"):
            prob.loss_fn(params, prob.data)
    else:
        assert torch.isfinite(prob.loss_fn(params, prob.data)[0])


def test_quality_lbfgs_phase_raises_and_bad_forms_are_refused():
    """The quality preset's two phases run (here cut to Adam 4 + L-BFGS 4,
    records every 2, at a small width): the L-BFGS records go on from the
    Adam count and its loss does not rise.  Unknown forms are refused."""
    q = tv.poisson1d_quality()
    cfg = dataclasses.replace(q, n_quad=8, n_test=4, layers=(1, 8, 8, 1), train=dataclasses.replace(
        q.train, iterations=4, lbfgs_iterations=4, check_every=2))
    res = tv.train(tv.build(cfg, device="cpu"), verbose=False)
    np.testing.assert_array_equal(res.history["iteration"], [2, 4, 6, 8])
    assert np.all(np.diff(res.history["loss"][1:]) <= 0) and res.phases["lbfgs"]["iterations"] == 4
    bad = tv.build(dataclasses.replace(configs()[1], var_form=4), device="cpu")
    params = bad.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="var_form"):
        bad.loss_fn(params, bad.data)
