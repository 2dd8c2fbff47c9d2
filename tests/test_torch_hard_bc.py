"""Port parity, the ansatzes the JVP engine serves: deriv_mode="jvp", the
hard-BC ansatz u = g + D N (Poisson-1D, Poisson-2D, AdvDiff), AdvDiff's
outflow-layer input feature and Poisson-2D's PINN scheme, against the JAX
package, in float64 on the CPU, at small sizes, from the same numpy
parameters given to both packages (through `convert` to the port).

Tolerances: loss, every aux key and the gradient of every leaf rtol 1e-10,
as the other parity tests hold them; the hard BC exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.problems import poisson1d as jp1d  # noqa: E402
from hpvpinns_tpu.problems import poisson2d as jp2d  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson1d as tp1d  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson2d as tp2d  # noqa: E402
from test_torch_parity import ADV, compare_loss_and_grads, shared_params, tnp  # noqa: E402

P2D = dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1), n_residual=40,
           dtype="float64")
P1D = dict(grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, n_quad=12, n_test=5, layers=(1, 8, 8, 1), dtype="float64")


def lift2(X, xp):
    return xp.sin(X[:, 0:1]) * X[:, 1:2]


def env2(X):
    return (1.0 - X[:, 0:1] ** 2) * (1.0 - X[:, 1:2] ** 2)


P2D_CASES = {
    "jvp_form0": dict(deriv_mode="jvp", var_form=0),
    "jvp_form1": dict(deriv_mode="jvp", var_form=1),
    "hard_bc_form0": dict(hard_bc=True, var_form=0),
    "hard_bc_form1": dict(hard_bc=True, var_form=1),
    "pinn": dict(scheme="PINNs"),
    "pinn_hard_bc": dict(scheme="PINNs", hard_bc=True),
}


@pytest.mark.parametrize("case", list(P2D_CASES))
def test_poisson2d_jvp_hard_bc_and_pinn_match_jax(case):
    kw = dict(P2D, **P2D_CASES[case])
    jprob, tprob = jv.build(jv.Poisson2DConfig(**kw)), tv.build(tv.Poisson2DConfig(**kw), device="cpu")
    for key in ("xb", "ub", "xf", "ff"):
        np.testing.assert_array_equal(tnp(tprob.data[key]), np.asarray(jprob.data[key]), err_msg=key)
    compare_loss_and_grads(jprob, tprob)
    assert (tprob.apply_override is None) == (jprob.apply_override is None)


def test_poisson2d_custom_lift_and_envelope_match_jax():
    """build's lift_fn / envelope_fn (torch in the port, jnp in JAX)."""
    kw = dict(P2D, var_form=1)
    jprob = jp2d.build(jv.Poisson2DConfig(**kw), None, None, None, lambda X: lift2(X, jnp), env2)
    tprob = tp2d.build(tv.Poisson2DConfig(**kw), None, None, None, lambda X: lift2(X, torch), env2, device="cpu")
    compare_loss_and_grads(jprob, tprob)


@pytest.mark.parametrize("case", [dict(deriv_mode="jvp", var_form=1), dict(hard_bc=True, var_form=1),
                                  dict(hard_bc=True, var_form=2), dict(hard_bc=True, var_form=3)])
def test_poisson1d_jvp_and_hard_bc_match_jax(case):
    kw = dict(P1D, **case)
    compare_loss_and_grads(jv.build(jv.Poisson1DConfig(**kw)), tv.build(tv.Poisson1DConfig(**kw), device="cpu"))


def test_poisson1d_hard_bc_argument_matches_jax():
    """build(cfg, u_fn, f_fn, hard_bc) with the positional hard_bc."""
    u = lambda x: np.sin(np.pi * x) + 0.25 * x  # noqa: E731
    f = lambda x: np.pi**2 * np.sin(np.pi * x)  # noqa: E731
    jprob = jp1d.build(jv.Poisson1DConfig(**P1D), u, f, True)
    tprob = tp1d.build(tv.Poisson1DConfig(**P1D), u, f, True, device="cpu")
    tparams = compare_loss_and_grads(jprob, tprob)
    X = torch.tensor([[-1.0], [1.0]], dtype=torch.float64)
    with torch.no_grad():  # the lift interpolates u(+-1) exactly
        np.testing.assert_allclose(tnp(tprob.apply(tparams, X)), u(np.array([[-1.0], [1.0]])), rtol=1e-15)


def test_poisson2d_hard_bc_holds_exactly_for_random_parameters():
    prob = tv.build(tv.Poisson2DConfig(**dict(P2D, hard_bc=True)), device="cpu")
    params = tv.params_from_jax(shared_params(prob, seed=4), dtype=torch.float64)
    s = torch.linspace(-1, 1, 21, dtype=torch.float64)[:, None]
    one = torch.ones_like(s)
    with torch.no_grad():
        for X in (torch.cat([s, one], 1), torch.cat([s, -one], 1), torch.cat([one, s], 1), torch.cat([-one, s], 1)):
            np.testing.assert_array_equal(tnp(prob.apply(params, X)), tnp(tp2d.default_lift(X)))
        # the default lift is the benchmark solution on the boundary, to roundoff
        edge = torch.cat([one, s], 1)
        np.testing.assert_allclose(tnp(prob.apply(params, edge)), tp2d.u_exact(1.0, tnp(s)), atol=1e-15)


ADV_CASES = {
    "hard_bc": dict(hard_bc=True),
    "hard_bc_form1": dict(hard_bc=True, var_form=1),
    "hard_bc_form2_velocity": dict(hard_bc=True, var_form=2, velocity_trainable=True),
    "jvp_form0_mlp": dict(deriv_mode="jvp", epsilon_model="mlp"),
    "layer_feature": dict(inverse=False, layer_feature=True),
    "layer_feature_hard_bc": dict(inverse=False, layer_feature=True, hard_bc=True, var_form=1),
}


@pytest.mark.parametrize("case", list(ADV_CASES))
def test_advdiff_jvp_ansatzes_match_jax(case):
    kw = dict(ADV, **ADV_CASES[case])
    jprob, tprob = jv.build(jv.AdvDiffConfig(**kw)), tv.build(tv.AdvDiffConfig(**kw), device="cpu")
    compare_loss_and_grads(jprob, tprob)
    assert tprob.spec.layers == jprob.spec.layers
