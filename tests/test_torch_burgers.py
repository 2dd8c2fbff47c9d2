"""Port parity, Burgers: the Cole-Hopf solution (float64 against JAX's, and
the torch twin in float32 across the shock), the lift, the envelope and the
training data (time slabs and handed-off ICs included), the element arrays
and the test grid, the loss, aux and gradients in forms 0/1 under "taylor",
"pallas" and "jvp", hard BC, the front feature and strong collocation in a
window, the strong residual and a short training run, against the JAX
package on the CPU at a tiny size (a non-uniform x-grid of three elements,
5 quadrature points, 3 x 3 test functions, a (2,6,6,1) tanh net, t in
[0, 0.5]), from the same numpy parameters.

Tolerances: host arrays to 1e-12; f64 loss, aux and gradients against JAX
"taylor" (JAX "jvp" under hard BC and the front feature) to rtol 1e-12
under "taylor" and "jvp" and 1e-10 under the port's "pallas" (its plain
versions on the CPU); in float32 against JAX "pallas" (interpret mode) the
loss at rtol 1e-6 and each gradient leaf at 2e-4 of its largest entry;
training records to rtol 1e-8.
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
from hpvpinns_tpu.problems import burgers as jbu  # noqa: E402
from hpvpinns_tpu_torch.problems import burgers as tbu  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import (  # noqa: E402
    compare_loss_and_grads, jax_loss_and_grads, named_leaves, shared_params, tnp, to_jax, train_gn_tail,
)

TINY = dict(grid_x=(-1.0, -0.2, 0.3, 1.0), n_elements_t=1, n_quad=5, n_test_x=3, n_test_t=3, layers=(2, 6, 6, 1),
            n_bound=6, t_final=0.5, dtype="float64")
F64 = dict(rtol=1e-12, atol=1e-14)
PALLAS = dict(rtol=1e-10, atol=1e-13)
NU = 0.01 / np.pi


def configs(**kw):
    kw = {**TINY, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return jv.BurgersConfig(**kw, train=jv.TrainConfig(**tkw)), tv.BurgersConfig(**kw, train=tv.TrainConfig(**tkw))


def build_both(*args, **kw):
    jcfg, tcfg = configs(**kw)
    return jbu.build(jcfg, None, *args), tbu.build(tcfg, None, *args, device="cpu")


def test_presets_match_jax_fields():
    """The config and its presets field for field; the precision preset's
    Gauss-Newton tail runs in train."""
    for name in ("BurgersConfig", "burgers_quality", "burgers_precision"):
        assert dataclasses.asdict(getattr(tv, name)()) == dataclasses.asdict(getattr(jv, name)()), name
    train_gn_tail(tv.build(dataclasses.replace(tv.burgers_precision(), **TINY), device="cpu"))


def test_cole_hopf_matches_jax_in_float64():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (40, 1))
    t = np.concatenate([np.zeros((5, 1)), rng.uniform(0, 1, (35, 1))])
    np.testing.assert_allclose(tbu.u_exact(x, t, NU), jbu.u_exact(x, t, NU), rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(tbu.u_exact(x[:5], t[:5], NU), tbu.u_initial(x[:5]))
    X = np.hstack([x, t])
    np.testing.assert_allclose(tnp(tbu.default_lift(torch.as_tensor(X))), np.asarray(jbu.default_lift(jnp.asarray(X))),
                               **F64)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(tnp(tbu.u_exact_torch(xt, 0.4, NU)), np.asarray(jbu.u_exact_jnp(jnp.asarray(x), 0.4, NU)),
                               rtol=1e-12, atol=1e-14)


def test_torch_twin_in_float32_has_no_nan_across_the_shock():
    """The torch twin in float32 at t = 0.5 against the float64 solution:
    finite everywhere, also in |x| <= 0.02, where the shock sits (the band
    that folding log(w) into the exponent's offset closes)."""
    x = np.concatenate([np.linspace(-0.02, 0.02, 81), np.linspace(-1, 1, 101)]).reshape(-1, 1)
    got = tnp(tbu.u_exact_torch(torch.as_tensor(x, dtype=torch.float32), 0.5, NU)).astype(np.float64)
    want = tbu.u_exact(x, np.full_like(x, 0.5), NU, n_hermite=96)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    # the offset is a constant for autograd: the gradient in x is finite too
    xt = torch.as_tensor(x, dtype=torch.float32).requires_grad_(True)
    (g,) = torch.autograd.grad(tbu.u_exact_torch(xt, 0.5, NU).sum(), xt)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("case", ["t0", "slab", "slab_ic_fn"])
def test_training_data_matches_jax(case):
    kw, ic_fn = {"t0": ({}, None), "slab": ({"t_start": 0.3}, None),
                 "slab_ic_fn": ({"t_start": 0.3}, lambda x: 0.5 * x**2)}[case]
    jcfg, tcfg = configs(**kw)
    jX, ju = jbu.training_data(jcfg, np.random.default_rng(3), ic_fn=ic_fn)
    tX, tu = tbu.training_data(tcfg, np.random.default_rng(3), ic_fn=ic_fn)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_allclose(tu, ju, **F64)
    X = torch.as_tensor(np.random.default_rng(4).uniform(0.3, 1, (7, 2)))
    np.testing.assert_allclose(tnp(tbu.make_default_envelope(tcfg)(X)),
                               np.asarray(jbu.make_default_envelope(jcfg)(jnp.asarray(tnp(X)))), **F64)


def test_problem_data_matches_jax():
    """Elements (non-uniform x- and t-grids, per-element test counts), bases,
    boundary and collocation points (in a strong window), the test grid and
    the extras."""
    jprob, tprob = build_both(grid_t=(0.0, 0.2, 0.5), n_test_x_per_elem=(3, 2, 3), n_strong=9,
                              strong_window=(-0.15, 0.15))
    for key in ("elements", "basis_x", "basis_t"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), **F64, err_msg=f.name)
    assert sorted(tprob.data) == sorted(jprob.data) == ["basis_t", "basis_x", "elements", "ub", "xb", "xr"]
    for key in ("xb", "xr"):
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]))
    assert np.abs(tnp(tprob.data["xr"])[:, 0]).max() <= 0.15
    np.testing.assert_allclose(tnp(tprob.data["ub"]), np.asarray(jprob.data["ub"]), **F64)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, rtol=1e-12, atol=1e-14)
    assert sorted(tprob.extras) == sorted(jprob.extras)  # reg_resvec_fn too, since the GN phase is ported
    assert tprob.extras["mesh"].shape == (3, 2) and tprob.extras["test_grid_shape"] == (51, 256)
    with pytest.raises(NotImplementedError, match="item 16"):
        tprob.extras["enriched_residual_fn"](tprob.init_params(torch.Generator().manual_seed(0)))


def test_time_slab_without_a_lift_raises():
    """hard_bc's default lift is the t = 0 IC: a slab start or a handed-off
    IC without an explicit lift_fn raises, as in the JAX package."""
    for kw, ic_fn in (({"t_start": 0.2}, None), ({}, lambda x: x)):
        _, tcfg = configs(hard_bc=True, **kw)
        with pytest.raises(ValueError, match="lift_fn"):
            tbu.build(tcfg, None, None, None, ic_fn, device="cpu")
    _, tcfg = configs(t_start=0.2)
    with pytest.raises(ValueError, match="lift_fn"):
        tbu.build(tcfg, None, None, lambda X: X[:, 0:1], device="cpu")
    tbu.build(tcfg, None, device="cpu")  # soft BC takes a slab


CASES = {
    "form0_taylor": ({"var_form": 0}, F64),
    "form1_taylor": ({"var_form": 1}, F64),
    "form0_pallas": ({"var_form": 0, "deriv_mode": "pallas"}, PALLAS),
    "form1_pallas": ({"var_form": 1, "deriv_mode": "pallas"}, PALLAS),
    "form0_jvp": ({"var_form": 0, "deriv_mode": "jvp"}, F64),
    "form1_jvp": ({"var_form": 1, "deriv_mode": "jvp"}, F64),
    "hard_bc_form0": ({"var_form": 0, "hard_bc": True}, F64),
    "front_feature_form1": ({"var_form": 1, "front_feature": True}, F64),
    "front_feature_hard_bc": ({"var_form": 0, "front_feature": True, "hard_bc": True, "front_feature_scale": 0.05}, F64),
    "strong_window_form0_pallas": ({"var_form": 0, "n_strong": 9, "strong_window": (-0.15, 0.15),
                                    "strong_weight": 0.5, "deriv_mode": "pallas"}, PALLAS),
    "slab_form1": ({"var_form": 1, "t_start": 0.25}, F64),
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
    kw, tight = CASES[case]
    ref = jax_reference(tuple(sorted((k, v) for k, v in kw.items() if k != "deriv_mode")))
    _, tprob = build_both(**kw)
    compare_loss_and_grads(None, tprob, tight=tight, jax_out=ref)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_f32_matches_jax_pallas(var_form):
    """float32 under "pallas": loss, every aux key and every gradient against
    the JAX kernels in interpret mode (form 0: u_tt's cotangent zero)."""
    jprob, tprob = build_both(var_form=var_form, deriv_mode="pallas", dtype="float32")
    tree = jax.tree.map(lambda a: a.astype(np.float32), shared_params(tprob))
    tparams = tv.params_from_jax(tree, dtype=torch.float32)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_loss_and_grads(jprob, to_jax(tree))
    assert sorted(taux) == sorted(jaux) == ["loss", "lossb", "lossv"]
    for k in taux:
        np.testing.assert_allclose(tnp(taux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)
    for (name, j), t in zip(named_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(tnp(t), j, rtol=0, atol=2e-4 * np.abs(j).max(), err_msg=name)


@pytest.mark.parametrize("kw", [{}, {"hard_bc": True, "front_feature": True}], ids=["soft", "hard_bc_feature"])
def test_strong_residual_matches_jax(kw):
    jprob, tprob = build_both(**kw)
    tree = shared_params(tprob)
    X = np.random.default_rng(5).uniform(0, 1, (20, 2)) * np.array([2, 1]) - np.array([1, 0])
    got = tv.strong_residual(tprob, tv.params_from_jax(tree, dtype=torch.float64), X)
    want = jevaluate.strong_residual(jprob, to_jax(tree), X)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-11, atol=1e-12)


def test_training_matches_jax():
    """8 Adam steps of form 0 under "pallas" (the plain versions on the CPU)
    against JAX "taylor": every record to rtol 1e-8, and evaluate() on the
    test grid."""
    train = dict(iterations=8, check_every=4)
    jprob, _ = build_both(var_form=0, train=train)
    _, tprob = build_both(var_form=0, deriv_mode="pallas", train=train)
    tree = shared_params(tprob)
    jres = jv.train(jprob, params=to_jax(tree), verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(tree, dtype=torch.float64), verbose=False)
    assert sorted(tres.history) == sorted(jres.history)
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    want, got = jv.evaluate_problem(jprob, jres.params), tv.evaluate_problem(tprob, tres.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
