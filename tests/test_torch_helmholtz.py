"""Port parity, Helmholtz-2D: the plane wave, its torch twin, the Coons lift
and the envelope, the boundary and sensor data (noise included), the element
arrays and the test grid, the loss, aux and gradients (k^2's included) in
forms 0/1 under "taylor", "pallas" and "jvp", hard BC, closed_form_k_sq, the
strong residual and a short training run, against the JAX package on the
CPU at a tiny size (a non-uniform x-grid of two elements, 5 quadrature
points, 3 x 3 test functions, a (2,6,6,1) tanh net), from the same numpy
parameters.

Tolerances: host arrays to 1e-12; f64 loss, aux and gradients against JAX
"taylor" (JAX "jvp" under hard BC) to rtol 1e-12 under "taylor" and "jvp"
and 1e-10 under the port's "pallas" (its plain versions on the CPU); in
float32 against JAX "pallas" (interpret mode) the loss at rtol 1e-6 and each
gradient leaf at 2e-4 of its largest entry; training records to rtol 1e-8.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import evaluate as jevaluate  # noqa: E402
from hpvpinns_tpu.problems import helmholtz as jhz  # noqa: E402
from hpvpinns_tpu_torch.problems import helmholtz as thz  # noqa: E402
from hpvpinns_tpu_torch.problems.base import map_params, parameters  # noqa: E402
from test_torch_parity import (  # noqa: E402
    compare_loss_and_grads, jax_loss_and_grads, named_leaves, shared_params, tnp, to_jax, train_gn_tail,
)

TINY = dict(grid_x=(-1.0, 0.25, 1.0), n_elements_y=1, n_quad=5, n_test_x=3, n_test_y=3, layers=(2, 6, 6, 1),
            n_bound=6, n_sensors=7, dtype="float64")
F64 = dict(rtol=1e-12, atol=1e-14)
PALLAS = dict(rtol=1e-10, atol=1e-13)


def configs(**kw):
    kw = {**TINY, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return jv.Helmholtz2DConfig(**kw, train=jv.TrainConfig(**tkw)), tv.Helmholtz2DConfig(**kw, train=tv.TrainConfig(**tkw))


def build_both(**kw):
    jcfg, tcfg = configs(**kw)
    return jhz.build(jcfg), thz.build(tcfg, device="cpu")


def test_presets_match_jax_fields():
    """The config and its presets field for field; the Gauss-Newton tails of
    the quality and precision presets run in train."""
    for name in ("Helmholtz2DConfig", "helmholtz2d_quality", "helmholtz2d_precision"):
        assert dataclasses.asdict(getattr(tv, name)()) == dataclasses.asdict(getattr(jv, name)()), name
    for name in ("helmholtz2d_quality", "helmholtz2d_precision"):
        train_gn_tail(tv.build(dataclasses.replace(getattr(tv, name)(), **TINY), device="cpu"))


def test_wave_lift_and_envelope_match_jax():
    jcfg, tcfg = configs(domain_y=(-0.5, 1.5), wave_angle_deg=20.0)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, (2, 9, 1))
    np.testing.assert_allclose(thz.make_exact(tcfg)(x, y), jhz.make_exact(jcfg)(x, y), **F64)
    X = np.hstack([x, y])
    Xt = torch.as_tensor(X)
    np.testing.assert_allclose(tnp(thz.make_exact_torch(tcfg)(Xt[:, 0:1], Xt[:, 1:2])),
                               np.asarray(jhz.make_exact_jnp(jcfg)(X[:, 0:1], X[:, 1:2])), **F64)
    tlift = thz.make_coons_lift(tcfg, thz.make_exact_torch(tcfg))
    jlift = jhz.make_coons_lift(jcfg, jhz.make_exact_jnp(jcfg))
    np.testing.assert_allclose(tnp(tlift(Xt)), np.asarray(jlift(jnp.asarray(X))), **F64)
    np.testing.assert_allclose(tnp(thz.make_envelope(tcfg)(Xt)), np.asarray(jhz.make_envelope(jcfg)(jnp.asarray(X))),
                               **F64)
    # the lift is the trace on every edge
    edge = torch.tensor([[-1.0, 0.3], [1.0, -0.2], [0.4, -0.5], [-0.7, 1.5]], dtype=torch.float64)
    np.testing.assert_allclose(tnp(tlift(edge)), tnp(thz.make_exact_torch(tcfg)(edge[:, 0:1], edge[:, 1:2])), **F64)
    assert thz.zero_forcing(x, y.T).shape == (9, 9)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_problem_data_matches_jax(noise):
    """Elements (non-uniform x-grid, per-element test counts), bases,
    boundary points, the inverse run's sensors and noisy readings, the test
    grid and the extras."""
    jprob, tprob = build_both(inverse=True, sensor_noise_std=noise, n_test_x_per_elem=(3, 2))
    for key in ("elements", "basis_x", "basis_y"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), **F64, err_msg=f.name)
    assert sorted(tprob.data) == sorted(jprob.data) == ["basis_x", "basis_y", "elements", "ub", "us", "xb", "xs"]
    for key in ("xb", "xs"):
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]))
    for key in ("ub", "us"):
        np.testing.assert_allclose(tnp(tprob.data[key]), np.asarray(jprob.data[key]), **F64)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, **F64)
    assert sorted(tprob.extras) == sorted(jprob.extras)  # reg_resvec_fn too, since the GN phase is ported
    assert tprob.extras["k_sq_true"] == jprob.extras["k_sq_true"] == 81.0
    assert tprob.extras["test_grid_shape"] == jprob.extras["test_grid_shape"]
    params = tprob.init_params(torch.Generator().manual_seed(0))
    assert params["pde"]["k_sq"].dim() == 0 and float(params["pde"]["k_sq"]) == 60.0
    with pytest.raises(NotImplementedError, match="item 16"):
        tprob.extras["enriched_residual_fn"](params)


CASES = {
    "form0_taylor": ({"var_form": 0}, F64),
    "form1_taylor": ({"var_form": 1}, F64),
    "form0_pallas": ({"var_form": 0, "deriv_mode": "pallas"}, PALLAS),
    "form1_pallas": ({"var_form": 1, "deriv_mode": "pallas"}, PALLAS),
    "form0_jvp": ({"var_form": 0, "deriv_mode": "jvp"}, F64),
    "form1_jvp": ({"var_form": 1, "deriv_mode": "jvp"}, F64),
    "inverse_form0_pallas": ({"var_form": 0, "inverse": True, "sensor_noise_std": 0.05, "deriv_mode": "pallas"}, PALLAS),
    "inverse_form1_taylor": ({"var_form": 1, "inverse": True}, F64),
    "hard_bc_form0": ({"var_form": 0, "hard_bc": True}, F64),
    "hard_bc_inverse_form1": ({"var_form": 1, "hard_bc": True, "inverse": True, "deriv_mode": "pallas"}, F64),
}


@functools.lru_cache(maxsize=None)
def jax_reference(key):
    """JAX "taylor"'s (aux, grads) at the case's settings (deriv_mode
    aside) and the port's shared parameters: the modes of one form share
    them, and their compilation."""
    jprob, tprob = build_both(**dict(key))
    return jax_loss_and_grads(jprob, to_jax(shared_params(tprob)))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_gradients_match_jax(case):
    """Against JAX "taylor" (hard BC: the JVP engine in both packages),
    k^2's gradient among the leaves of inverse runs."""
    kw, tight = CASES[case]
    ref = jax_reference(tuple(sorted((k, v) for k, v in kw.items() if k != "deriv_mode")))
    _, tprob = build_both(**kw)
    compare_loss_and_grads(None, tprob, tight=tight, jax_out=ref)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_f32_matches_jax_pallas(var_form):
    """float32 inverse run under "pallas": loss, every aux key and every
    gradient, k^2's included, against the JAX kernels in interpret mode."""
    jprob, tprob = build_both(var_form=var_form, inverse=True, deriv_mode="pallas", dtype="float32")
    tree = jax.tree.map(lambda a: a.astype(np.float32), shared_params(tprob))
    tparams = tv.params_from_jax(tree, dtype=torch.float32)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_loss_and_grads(jprob, to_jax(tree))
    assert sorted(taux) == sorted(jaux) == ["k_sq", "loss", "lossb", "losss", "lossv"]
    for k in taux:
        np.testing.assert_allclose(tnp(taux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)
    assert [n for n, _ in named_leaves(jgrads)][-1] == "pde.k_sq"
    for (name, j), t in zip(named_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(tnp(t), j, rtol=0, atol=2e-4 * np.abs(j).max(), err_msg=name)


def test_k_sq_leaf_carries_across_and_orders_like_epsilon():
    """params_from_jax and map_params carry the 0-d k_sq leaf, and
    `parameters` puts it after the net, as JAX's tree order does."""
    _, tprob = build_both(inverse=True)
    tree = shared_params(tprob)
    tree["pde"]["k_sq"] = np.float64(77.5)
    tparams = tv.params_from_jax(tree, dtype=torch.float64)
    leaves = parameters(tparams)
    assert leaves[-1] is tparams["pde"]["k_sq"] and leaves[-1].dim() == 0 and float(leaves[-1]) == 77.5
    assert len(leaves) == len(jax.tree.leaves(to_jax(tree)))
    doubled = map_params(lambda t: 2 * t, tparams)
    assert float(doubled["pde"]["k_sq"]) == 155.0
    assert tv.params_to_numpy(tparams)["pde"]["k_sq"] == 77.5


def test_closed_form_k_sq_matches_jax():
    jprob, tprob = build_both(var_form=1, inverse=True)
    tree = shared_params(tprob)
    got = thz.closed_form_k_sq(tprob, tv.params_from_jax(tree, dtype=torch.float64))
    want = jhz.closed_form_k_sq(jprob, to_jax(tree))
    assert got == pytest.approx(want, rel=1e-11)
    _, forward = build_both()
    with pytest.raises(ValueError, match="inverse"):
        thz.closed_form_k_sq(forward, forward.init_params(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("kw", [{}, {"inverse": True, "hard_bc": True}], ids=["forward", "inverse_hard_bc"])
def test_strong_residual_matches_jax(kw):
    jprob, tprob = build_both(**kw)
    tree = shared_params(tprob)
    X = np.random.default_rng(5).uniform(-1, 1, (20, 2))
    got = tv.strong_residual(tprob, tv.params_from_jax(tree, dtype=torch.float64), X)
    want = jevaluate.strong_residual(jprob, to_jax(tree), X)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-11, atol=1e-10)


def test_training_matches_jax():
    """8 Adam steps of an inverse form-0 run under "pallas" (the plain
    versions on the CPU) against JAX "taylor": every record, k^2 among
    them, to rtol 1e-8, and evaluate() on the test grid."""
    train = dict(iterations=8, check_every=4)
    jprob, _ = build_both(var_form=0, inverse=True, train=train)
    _, tprob = build_both(var_form=0, inverse=True, deriv_mode="pallas", train=train)
    tree = shared_params(tprob)
    jres = jv.train(jprob, params=to_jax(tree), verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(tree, dtype=torch.float64), verbose=False)
    assert sorted(tres.history) == sorted(jres.history)
    assert "k_sq" in tres.history
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    want, got = jv.evaluate_problem(jprob, jres.params), tv.evaluate_problem(tprob, tres.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
