"""Port parity, the slice as a whole: the Poisson-2D problem and the Adam
trainer of the PyTorch port against the JAX package, in float64 on the CPU,
at a small size (2x2 elements, 6 quadrature points, 3x3 test functions, a
(2,8,8,1) tanh net), from the same JAX-initialised parameters.

Tolerances: loss and gradients rtol 1e-10 (the same f64 arithmetic in
another summation order); 20 Adam steps rtol 1e-8 (Adam's division by
sqrt(v) amplifies roundoff).  The port's deriv_mode "pallas" on the CPU is
the plain Taylor propagation in float64, so it is held to the JAX "taylor"
numbers at those tolerances.  The JAX "pallas" kernel accumulates its dots
in float32 (pallas_fields.py:68, preferred_element_type) even in float64
mode, so against it the port is held at rtol 1e-6 / atol 1e-9, which is the
size of that f32 rounding."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402

SMALL = dict(
    n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3,
    layers=(2, 8, 8, 1), dtype="float64",
)
TIGHT = dict(rtol=1e-10, atol=1e-13)


def configs(deriv_mode="taylor", **train):
    tcfg = tv.TrainConfig(iterations=20, check_every=10, **train)
    jcfg = jv.TrainConfig(iterations=20, check_every=10, **train)
    return (
        jv.Poisson2DConfig(**SMALL, deriv_mode=deriv_mode, train=jcfg),
        tv.Poisson2DConfig(**SMALL, deriv_mode=deriv_mode, train=tcfg),
    )


@pytest.fixture(scope="module")
def jax_side():
    jcfg, _ = configs()
    prob = jv.build(jcfg)
    params = prob.init_params(jax.random.key(0))
    return prob, params, jax.tree.map(np.asarray, params)


def jax_loss_and_grads(prob, params):
    """(aux, gradient leaves W_0, b_0, ...) of a JAX problem's loss."""
    (_, aux), grads = jax.jit(jax.value_and_grad(prob.loss_fn, has_aux=True))(params, prob.data)
    return aux, [np.asarray(a) for layer in grads["net"] for a in (layer["W"], layer["b"])]


def tnp(t):
    return t.detach().cpu().numpy()


def test_problem_data_matches_jax(jax_side):
    jprob, _, _ = jax_side
    tprob = tv.build(configs()[1])
    for key in ("elements", "basis_x", "basis_y"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), rtol=1e-13, atol=1e-14)
    for key in ("xb", "ub"):
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]))
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_array_equal(tprob.test_values, jprob.test_values)
    moved = tprob.data["elements"].to("cpu")
    assert type(moved) is type(tprob.data["elements"])
    np.testing.assert_array_equal(tnp(moved.f_proj), tnp(tprob.data["elements"].f_proj))


@pytest.mark.parametrize("deriv_mode", ["taylor", "pallas"])
def test_loss_and_gradients_match_jax(jax_side, deriv_mode):
    jprob, jparams, np_params = jax_side
    tprob = tv.build(configs(deriv_mode)[1])
    tparams = tv.params_from_jax(np_params, dtype=torch.float64)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))

    jaux, jgrads = jax_loss_and_grads(jprob, jparams)
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(tnp(taux[k]), float(jaux[k]), **TIGHT, err_msg=k)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(tnp(t), j, **TIGHT)

    if deriv_mode == "pallas":  # the JAX kernel itself, f32-accumulated
        jpaux, jpgrads = jax_loss_and_grads(jv.build(configs("pallas")[0]), jparams)
        np.testing.assert_allclose(tnp(tloss), float(jpaux["loss"]), rtol=1e-6)
        for t, j in zip(tgrads, jpgrads):
            np.testing.assert_allclose(tnp(t), j, rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def jax_trained(jax_side):
    jprob, jparams, _ = jax_side
    return jv.train(jprob, params=jparams, verbose=False)


@pytest.mark.parametrize("deriv_mode", ["taylor", "pallas"])
def test_adam_history_and_params_match_jax(jax_side, jax_trained, deriv_mode):
    _, _, np_params = jax_side
    tprob = tv.build(configs(deriv_mode)[1])
    start = tv.params_from_jax(np_params, dtype=torch.float64)
    res = tv.train(tprob, params=start, verbose=False)
    jres = jax_trained
    assert res.iterations_run == jres.iterations_run == 20
    np.testing.assert_array_equal(res.history["iteration"], jres.history["iteration"])
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(res.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    for t, j in zip(res.params["net"], jres.params["net"]):
        for name in ("W", "b"):
            np.testing.assert_allclose(tnp(t[name]), np.asarray(j[name]), rtol=1e-8, atol=1e-12)
    # the caller's params are copied, never updated in place
    np.testing.assert_array_equal(tnp(start["net"][0]["W"]), np_params["net"][0]["W"])
    # evaluation on the 201 x 201 grid agrees too
    tev = tv.evaluate_problem(tprob, res.params)
    jev = jv.evaluate_problem(jax_side[0], jres.params)
    np.testing.assert_allclose(tev["rel_l2"], jev["rel_l2"], rtol=1e-8)
    assert tv.predict(tprob, res.params).shape == (201 * 201, 1)


def test_threshold_stop_and_best_snapshot():
    _, tcfg = configs(threshold=1e9, best_snapshot_fraction=0.0)
    res = tv.train(tv.build(tcfg), verbose=False)
    assert res.stopped_early and res.iterations_run == 10 and len(res.history["loss"]) == 1
    for b, p in zip(res.best_params["net"], res.params["net"]):
        np.testing.assert_array_equal(tnp(b["W"]), tnp(p["W"]))
    assert res.eval_params is res.best_params


@pytest.mark.parametrize(
    "train_kw", [{"lbfgs_iterations": 5}, {"gn_iterations": 5}, {"checkpoint_dir": "ckpt"}]
)
def test_unported_training_phases_raise(train_kw):
    _, tcfg = configs(**train_kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        tv.train(tv.build(tcfg), verbose=False)


@pytest.mark.parametrize(
    "cfg_kw", [{"hard_bc": True}, {"scheme": "PINNs"}, {"var_form": 0}, {"var_form": "2c"}]
)
def test_unported_problem_options_raise(cfg_kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        tv.build(dataclasses.replace(configs()[1], **cfg_kw))


def test_presets_match_jax_fields():
    for name in ("poisson2d_of_record", "poisson2d_quality", "poisson2d_scaled"):
        t, j = getattr(tv, name)(), getattr(jv, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    with pytest.raises(ValueError, match="deriv_mode"):
        tv.build(dataclasses.replace(configs()[1], deriv_mode="jvp"))


def test_multi_device_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        tv.train(tv.build(configs()[1]), verbose=False, mesh=object())
