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
size of that f32 rounding.

The second-derivative forms 0, 2 and "2c" run the same way; under "pallas"
their gradient is B2's.  The JAX backward kernel keeps its scratch in float32
(pallas_fields.py:426-430) and refuses float64 values, so against JAX
"pallas" their float64 loss is held at rtol 1e-6 and their gradients are
compared in float32, at 2e-4 of each leaf's largest entry (B2's
tolerance)."""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.parallel.sharding import element_mesh  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import one_torch_thread, option_matches_default  # noqa: E402

SMALL = dict(
    n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3,
    layers=(2, 8, 8, 1), dtype="float64",
)
TIGHT = dict(rtol=1e-10, atol=1e-13)


def configs(deriv_mode="taylor", var_form=1, dtype="float64", **train):
    tcfg = tv.TrainConfig(iterations=20, check_every=10, **train)
    jcfg = jv.TrainConfig(iterations=20, check_every=10, **train)
    kw = dict(SMALL, deriv_mode=deriv_mode, var_form=var_form, dtype=dtype)
    return jv.Poisson2DConfig(**kw, train=jcfg), tv.Poisson2DConfig(**kw, train=tcfg)


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
    tprob = tv.build(configs(deriv_mode)[1], device="cpu")
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
    tprob = tv.build(configs(deriv_mode)[1], device="cpu")
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
    res = tv.train(tv.build(tcfg, device="cpu"), verbose=False)
    assert res.stopped_early and res.iterations_run == 10 and len(res.history["loss"]) == 1
    for b, p in zip(res.best_params["net"], res.params["net"]):
        np.testing.assert_array_equal(tnp(b["W"]), tnp(p["W"]))
    assert res.eval_params is res.best_params


def test_lbfgs_phase_runs_and_records_its_iterations():
    """Adam 20 + L-BFGS 5 with records every 10: the L-BFGS records go on
    from the Adam count (20 -> 25), and its loss does not rise."""
    _, tcfg = configs(lbfgs_iterations=5)
    res = tv.train(tv.build(tcfg, device="cpu"), verbose=False)
    np.testing.assert_array_equal(res.history["iteration"], [10, 20, 25])
    assert res.iterations_run == 25 and res.history["loss"][2] <= res.history["loss"][1]


@pytest.mark.parametrize("train_kw", [{"gn_iterations": 5}, {"checkpoint_dir": "ckpt"}])
def test_unported_training_phases_raise(train_kw, tmp_path):
    """The two training phases that raised until they were ported now run:
    five Gauss-Newton/LM steps after Adam 20, and checkpoints (the one at
    the end of the run; training/checkpoint.py)."""
    train_kw = {k: str(tmp_path / v) if k == "checkpoint_dir" else v for k, v in train_kw.items()}
    _, tcfg = configs(**train_kw)
    with one_torch_thread():
        res = tv.train(tv.build(tcfg, device="cpu"), verbose=False)
    if "gn_iterations" in train_kw:
        assert res.phases["gn"]["accepted"] == 5 and res.history["iteration"][-1] == 25
    else:
        assert os.listdir(train_kw["checkpoint_dir"]) == ["step_00000020"]


@pytest.mark.parametrize(
    "cfg_kw", [{"hard_bc": True, "adaptive_slope": True}, {"scheme": "PINNs", "matmul_precision": "default"},
               {"adaptive_slope": True}, {"matmul_precision": "high"}]
)
def test_unported_problem_options_raise(cfg_kw):
    """The adaptive slope and matmul precision "high"/"default" are ported,
    with hard BC and the PINN scheme too: they build and match the default
    on the CPU at the initial state (s = 1, no TF32 on the CPU)."""
    base = {k: v for k, v in cfg_kw.items() if k not in ("adaptive_slope", "matmul_precision")}
    option_matches_default(dataclasses.replace(configs()[1], **base),
                           **{k: v for k, v in cfg_kw.items() if k not in base})


def test_presets_match_jax_fields():
    for name in ("poisson2d_of_record", "poisson2d_quality", "poisson2d_scaled", "poisson2d_precision"):
        t, j = getattr(tv, name)(), getattr(jv, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    with pytest.raises(ValueError, match="deriv_mode"):
        tv.build(dataclasses.replace(configs()[1], deriv_mode="autodiff"), device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        tv.build(dataclasses.replace(configs()[1], scheme="PINN"), device="cpu")
    with pytest.raises(ValueError, match="var_form"):
        tv.build(dataclasses.replace(configs()[1], var_form=3), device="cpu")


def test_multi_device_mesh_raises():
    """`mesh` no longer raises: on a one-rank element mesh (gloo on the
    CPU) the eager chunks' records and parameters equal the unsharded
    run's bit for bit (one rank's all-reduce is a copy)."""
    prob = tv.build(configs()[1], device="cpu")
    with one_torch_thread():
        plain = tv.train(prob, verbose=False)
        meshed = tv.train(prob, verbose=False, mesh=element_mesh(device="cpu"))
    assert meshed.chunk_mode == plain.chunk_mode == "eager"
    np.testing.assert_array_equal(meshed.history["loss"], plain.history["loss"])
    for a, b in zip(parameters(meshed.params), parameters(plain.params), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("preset", ["poisson1d_of_record", "poisson2d_scaled", "poisson3d_quality", "AdvDiff2DConfig"])
def test_build_defaults_to_the_card(preset):
    """With no `device`, problems are built on the card; with no CUDA device
    that raises and names device="cpu" (it never moves to the CPU itself)."""
    cfg = dataclasses.replace(getattr(tv, preset)(), n_quad=4)
    if torch.cuda.is_available():
        assert tv.build(cfg).data["xb"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tv.build(cfg)
    assert tv.build(cfg, device="cpu").data["xb"].device.type == "cpu"


@pytest.mark.parametrize("deriv_mode", ["taylor", "pallas"])
@pytest.mark.parametrize("var_form", [0, 2, "2c"])
def test_second_derivative_forms_match_jax(jax_side, jax_taylor, var_form, deriv_mode):
    _, jparams, np_params = jax_side
    jcfg, tcfg = configs(deriv_mode, var_form)
    if var_form == 2:  # SMALL has 2 x 2 elements: both packages warn
        with pytest.warns(UserWarning, match="var_form=2"):
            tprob = tv.build(tcfg, device="cpu")
    else:
        tprob = tv.build(tcfg, device="cpu")
    tparams = tv.params_from_jax(np_params, dtype=torch.float64)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))

    jaux, jgrads = jax_taylor(var_form)
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(tnp(taux[k]), float(jaux[k]), **TIGHT, err_msg=k)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(tnp(t), j, **TIGHT)

    if deriv_mode == "pallas":  # the JAX kernels themselves
        jprob = jv.build(jcfg)
        np.testing.assert_allclose(tnp(tloss), float(jax.jit(jprob.loss_fn)(jparams, jprob.data)[0]), rtol=1e-6)
        jcfg32, tcfg32 = configs("pallas", var_form, dtype="float32")
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        _, jgrads32 = jax_loss_and_grads(jv.build(jcfg32), p32)
        tprob32 = tv.build(tcfg32, device="cpu")
        tparams32 = tv.params_from_jax(np_params, dtype=torch.float32)
        tgrads32 = torch.autograd.grad(tprob32.loss_fn(tparams32, tprob32.data)[0], parameters(tparams32))
        for t, j in zip(tgrads32, jgrads32):
            np.testing.assert_allclose(tnp(t), j, rtol=0, atol=2e-4 * np.abs(j).max())
