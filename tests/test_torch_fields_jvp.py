"""Port parity, the JVP engine: ops/derivatives.py and ops/fields.py of the
PyTorch port against the JAX package's (every flag, on a bare network and
on a lift + envelope composite, with the gradients of the fields with
respect to the parameters), and the strong residual of Poisson-1D,
Poisson-2D and AdvDiff, in float64 on the CPU, at small sizes, from the
same numpy parameters given to both packages.  tests/test_torch_hard_bc.py
holds the ansatzes the engine serves.

Tolerances: the fields and their parameter gradients rtol 1e-12 (the same
f64 arithmetic: nested forward-mode derivatives in both); the strong
residual rtol 1e-10, as the other parity tests hold whole problems.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.evaluate import strong_residual as jstrong_residual  # noqa: E402
from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.models.mlp import mlp_apply as japply  # noqa: E402
from hpvpinns_tpu.ops import fields as jfields  # noqa: E402
from hpvpinns_tpu.problems import advdiff as jad  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply  # noqa: E402
from hpvpinns_tpu_torch.ops import fields as tfields  # noqa: E402
from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d  # noqa: E402
from hpvpinns_tpu_torch.problems import advdiff as tad  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import ADV, TIGHT, epsilon_field, shared_params, tnp, to_jax, velocity_field  # noqa: E402

FIELDS_TOL = dict(rtol=1e-12, atol=1e-13)
P2D = dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1), dtype="float64")
P1D = dict(grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, n_quad=12, n_test=5, layers=(1, 8, 8, 1), dtype="float64")


def both_nets(layers, activation, seed=0):
    """A random network as (port params, JAX params) from one numpy draw."""
    rng = np.random.default_rng(seed)
    tree = {"net": [{"W": rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)), "b": 0.2 * rng.standard_normal(b)}
                    for a, b in zip(layers[:-1], layers[1:])], "pde": {}}
    return tv.params_from_jax(tree, dtype=torch.float64), to_jax(tree)


def lift2(X, xp):
    return xp.sin(X[:, 0:1]) * X[:, 1:2]


def env2(X):
    return (1.0 - X[:, 0:1] ** 2) * (1.0 - X[:, 1:2] ** 2)


def ansatz_2d(kind, spec, jspec, tp, jp):
    """(port u_fn, JAX u_fn): the bare network or the composite lift + envelope * N."""
    if kind == "mlp":
        return (lambda X: mlp_apply(spec, tp["net"], X)), (lambda X: japply(jspec, jp["net"], X))
    return ((lambda X: lift2(X, torch) + env2(X) * mlp_apply(spec, tp["net"], X)),
            (lambda X: lift2(X, jnp) + env2(X) * japply(jspec, jp["net"], X)))


@pytest.mark.parametrize("kind", ["mlp", "composite"])
def test_scalar_fields_1d_match_jax(kind):
    layers = (1, 10, 10, 1)
    tp, jp = both_nets(layers, "sin")
    spec, jspec = MLP(layers=layers, activation="sin"), JMLP(layers=layers, activation="sin")
    x = np.random.default_rng(1).uniform(-1, 1, (3, 7))
    if kind == "mlp":
        tu, ju = (lambda X: mlp_apply(spec, tp["net"], X)), (lambda X: japply(jspec, jp["net"], X))
    else:
        tu = lambda X: 0.3 + X * 0.5 + (X + 1) * (1 - X) * mlp_apply(spec, tp["net"], X)  # noqa: E731
        ju = lambda X: 0.3 + X * 0.5 + (X + 1) * (1 - X) * japply(jspec, jp["net"], X)  # noqa: E731
    got = tfields.scalar_fields_1d(tu, torch.as_tensor(x))
    want = jfields.scalar_fields_1d(ju, jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.shape == (3, 7)
        np.testing.assert_allclose(tnp(g), np.asarray(w), **FIELDS_TOL)


FLAGS = {"second_y": {}, "first_y_only": {"first_y_only": True}, "firsts_only": {"firsts_only": True},
         "x_only": {"second_y": False}}


@pytest.mark.parametrize("kind", ["mlp", "composite"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_scalar_fields_2d_and_their_gradients_match_jax(flag, kind):
    """Every flag of scalar_fields_2d: the fields, and the gradient of a
    weighted sum of them with respect to every parameter (reverse mode
    through the nested forward-mode levels), against JAX's."""
    layers = (2, 9, 9, 1)
    tp, jp = both_nets(layers, "tanh", seed=2)
    spec, jspec = MLP(layers=layers, activation="tanh"), JMLP(layers=layers, activation="tanh")
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-1, 1, (2, 4, 5)), rng.uniform(-1, 1, (2, 4, 5))
    kw = FLAGS[flag]

    def tfl(tparams):
        tu, _ = ansatz_2d(kind, spec, jspec, tparams, jp)
        return tfields.scalar_fields_2d(tu, torch.as_tensor(x), torch.as_tensor(y), **kw)

    def jfl(jparams):
        _, ju = ansatz_2d(kind, spec, jspec, tp, jparams)
        return jfields.scalar_fields_2d(ju, jnp.asarray(x), jnp.asarray(y), **kw)

    got, want = tfl(tp), jfl(jp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (2, 4, 5)
        np.testing.assert_allclose(tnp(got[k]), np.asarray(want[k]), **FIELDS_TOL, err_msg=k)

    weights = {k: rng.standard_normal((2, 4, 5)) for k in sorted(want)}
    tloss = sum((got[k] * torch.as_tensor(w)).sum() for k, w in weights.items())
    tgrads = torch.autograd.grad(tloss, parameters(tp))
    jgrads = jax.grad(lambda p: sum(jnp.sum(jfl(p)[k] * w) for k, w in weights.items()))(jp)
    jleaves = [a for layer in jgrads["net"] for a in (layer["W"], layer["b"])]
    for t, j in zip(tgrads, jleaves):
        np.testing.assert_allclose(tnp(t), np.asarray(j), **FIELDS_TOL)
    if kind == "mlp" and flag != "x_only":  # the same fields as the Taylor propagation's
        taylor = taylor_fields_2d(spec, tp["net"], torch.as_tensor(x), torch.as_tensor(y), **kw)
        for k in taylor:
            np.testing.assert_allclose(tnp(got[k]), tnp(taylor[k]), **FIELDS_TOL, err_msg=k)


STRONG = {  # id: (package config name, overrides, manufactured)
    "poisson1d": ("Poisson1DConfig", P1D, False),
    "poisson1d_hard_bc": ("Poisson1DConfig", dict(P1D, hard_bc=True), False),
    "poisson2d": ("Poisson2DConfig", P2D, False),
    "poisson2d_hard_bc": ("Poisson2DConfig", dict(P2D, hard_bc=True), False),
    "advdiff": ("AdvDiffConfig", ADV, False),
    "advdiff_quadraticvelocity_fieldocity": ("AdvDiffConfig", dict(ADV, epsilon_model="quadratic", velocity_trainable=True,
                                                         velocity_model="linear"), False),
    "advdiff_mlp_hard_bc": ("AdvDiffConfig", dict(ADV, epsilon_model="mlp", hard_bc=True), False),
    "advdiff_cos_forward": ("AdvDiffConfig", dict(ADV, inverse=False), True),
}


@pytest.mark.parametrize("case", list(STRONG))
def test_strong_residual_matches_jax(case):
    """The strong residual of the full ansatz at 64 random points in the
    domain (and at the default test grid for the 1-D problem)."""
    name, kw, manufactured = STRONG[case]
    jcfg, tcfg = getattr(jv, name)(**kw), getattr(tv, name)(**kw)
    if manufactured:
        u_fn, f_fn = tad.make_manufactured(tcfg, velocity_field, epsilon=epsilon_field, profile="cos")
        ju, jf = jad.make_manufactured(jcfg, velocity_field, epsilon=epsilon_field, profile="cos")
        jprob = jad.build(jcfg, None, None, None, ju, jf, velocity_field, epsilon_field)
        tprob = tad.build(tcfg, None, None, None, u_fn, f_fn, velocity_field, epsilon_field, device="cpu")
    else:
        jprob, tprob = jv.build(jcfg), tv.build(tcfg, device="cpu")
    tree = shared_params(tprob)
    rng = np.random.default_rng(5)
    d = tprob.test_points.shape[1]
    X = np.column_stack([rng.uniform(-1, 1, 64), rng.uniform(0.0 if name == "AdvDiffConfig" else -1.0, 0.3, 64)])[:, :d]
    got = tv.strong_residual(tprob, tv.params_from_jax(tree, dtype=torch.float64), X)
    want = np.asarray(jstrong_residual(jprob, to_jax(tree), X))
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_allclose(got, want, **TIGHT)
    if d == 1:
        np.testing.assert_allclose(tv.strong_residual(tprob, tv.params_from_jax(tree, dtype=torch.float64)),
                                   np.asarray(jstrong_residual(jprob, to_jax(tree))), **TIGHT)
